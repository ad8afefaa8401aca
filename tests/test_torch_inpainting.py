"""The port's inpainting-game protocol and blend+encode family against the
JAX package, on the toy net (tests/fixtures.make_toy_wbnet and its port
twin, tests/torch_fixtures.torch_twin, same weights).

Thresholds, masks, enter counts and the IoU integers are numpy on both
sides and must be identical.  Within the port, every device-blend program
must equal the host float64 blend path bit for bit (a binary mask is a
per-pixel select).  Against JAX the embeddings hold at float32 rtol 1e-5
with atol 1e-6 of their largest entry, the distances at rtol 1e-5 /
atol 1e-6, and the twin classifications are equal at every threshold
whose |pg - pr| exceeds 1e-5, ten times the distances' tolerance.
"""

import numpy as np
import pytest
import torch

from xfr_tpu.inpainting_game import protocol as JP
from tests.fixtures import make_toy_wbnet
from tests.torch_fixtures import torch_twin

from xfr_torch.inpainting_game import protocol as TP

PCT = np.arange(0, 101)
CLS_MARGIN = 1e-5


def _emb_close(got, want):
    """Embeddings (the toy net's are 50 x a unit vector) at float32 rtol
    1e-5 and atol 1e-6 of their largest entry; the measured gap is 3.1e-6
    absolute on entries up to 50."""
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-6 * np.abs(want).max())


def _nets(seed=2):
    jwb = make_toy_wbnet(num_classes=4, seed=seed)
    return jwb, torch_twin(jwb)


def _pair(seed, dtype=np.float32):
    rng = np.random.RandomState(seed)
    orig = (rng.rand(3, 224, 224) * 50).astype(dtype)
    inp = orig + (rng.rand(3, 224, 224) * 30).astype(dtype)
    return orig, inp


def _smap(rng, boost=True):
    s = rng.rand(224, 224)
    if boost:
        s[40:120, 60:160] += 4.0
    return s / s.sum()


def _gal(wb, *ims):
    """Unit-normed embeddings of each image, [1, D] each (the port's
    embeddings; the JAX net gives the same to 1e-6)."""
    out = []
    for im in ims:
        e = np.asarray(wb.embeddings(np.asarray(im, np.float32)[None]))
        out.append(e / np.linalg.norm(e, axis=1, keepdims=True))
    return out


def _cls_agree(got, want):
    """Twin classifications equal wherever |pg - pr| (the JAX side's)
    exceeds CLS_MARGIN; distances within float32 tolerance."""
    (cls_t, pg_t, pr_t), (cls_j, pg_j, pr_j) = got, want
    np.testing.assert_allclose(pg_t, pg_j, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(pr_t, pr_j, rtol=1e-5, atol=1e-6)
    sure = np.abs(np.asarray(pg_j) - np.asarray(pr_j)) > CLS_MARGIN
    np.testing.assert_array_equal(cls_t[sure], np.asarray(cls_j)[sure])


# ---------------------------------------------------------------------------
# Thresholds, masks and the IoU integers: numpy on both sides, identical
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("method", ["percent-density", "percentile"])
@pytest.mark.parametrize("include_zero", [True, False])
def test_threshold_planes_and_masks_equal_jax(method, include_zero):
    rng = np.random.RandomState(3)
    smap = rng.rand(63, 57)
    smap[smap < 0.3] = 0.0
    smap /= smap.sum()
    pct = np.unique(np.append(np.arange(0, 100, 7), [0, 100]))
    kw = dict(percentiles=pct, seed=11, include_zero_elements=include_zero)
    p_t, thr_t = TP._threshold_plane(smap, method, **kw)
    p_j, thr_j = JP._threshold_plane(smap, method, **kw)
    np.testing.assert_array_equal(p_t, p_j)
    np.testing.assert_array_equal(thr_t, thr_j)
    np.testing.assert_array_equal(TP.create_threshold_masks(smap, method,
                                                            **kw),
                                  JP.create_threshold_masks(smap, method,
                                                            **kw))
    blur_t = TP.create_threshold_masks(smap, method, blur_sigma=2.0, **kw)
    blur_j = JP.create_threshold_masks(smap, method, blur_sigma=2.0, **kw)
    np.testing.assert_array_equal(blur_t, blur_j)


@pytest.mark.parametrize("include_zero", [True, False])
def test_iou_integers_equal_jax(include_zero):
    rng = np.random.RandomState(4)
    smap = rng.rand(224, 224)
    smap[smap < 0.2] = 0.0
    gt = np.zeros((224, 224), np.uint8)
    gt[60:120, 80:150] = 255
    kw = dict(percentiles=PCT, seed=7, include_zero_elements=include_zero,
              return_fpos=True, return_tpos=True)
    got = TP.intersect_over_union_thresholded_saliency(
        smap, gt, "percent-density", **kw)
    want = JP.intersect_over_union_thresholded_saliency(
        smap, gt, "percent-density", **kw)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    # the last mask covers every pixel, or every nonzero one
    covered = smap > 0 if not include_zero else True
    assert got[2][-1] == ((gt > 0) & covered).sum()


def test_hiding_game_and_regions_match_jax():
    rng = np.random.RandomState(0)
    smap = rng.rand(16, 16)
    img = rng.rand(16, 16, 3)

    def masking_fn(masks, image):
        return masks[..., None] * image[None]

    def scoring_fn(masked):
        return masked.mean(axis=(1, 2, 3))

    got = TP.HidingGame(smap, img, masking_fn, scoring_fn,
                        delta_pct=10.0).evaluate()
    want = JP.HidingGame(smap, img, masking_fn, scoring_fn,
                         delta_pct=10.0).evaluate()
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    region = np.zeros((100, 100))
    region[20:60, 30:70] = 1.0
    smaps = {"a": rng.rand(100, 100), "b": rng.rand(100, 100) ** 3}
    for of_total in (True, False):
        ref_t, nm_t, p_t = TP.hidinggame_mated_nonmated_regions(
            smaps, region, of_total=of_total)
        ref_j, nm_j, p_j = JP.hidinggame_mated_nonmated_regions(
            smaps, region, of_total=of_total)
        np.testing.assert_array_equal(p_t, p_j)
        for k in smaps:
            np.testing.assert_array_equal(ref_t[k], ref_j[k])
            np.testing.assert_array_equal(nm_t[k], nm_j[k])


# ---------------------------------------------------------------------------
# Blend + encode, within the port and against JAX
# ---------------------------------------------------------------------------


def test_device_blend_path_matches_host_and_jax():
    """The counts path of classified_as_inpainted_twin is bit-identical to
    the host float64 blend path within the port; against JAX the
    distances hold at float32 tolerance.  Blurred masks keep the host
    path."""
    jwb, twb = _nets(seed=1)
    rng = np.random.RandomState(5)
    orig, inp = _pair(5, np.float64)
    smap = _smap(rng)
    og, ig = _gal(twb, orig, inp)

    class HostOnly:
        """Hides the device blend API: the host path."""

        def embeddings(self, x, norm=True):
            return twb.embeddings(x, norm=norm)

    kw = dict(original_gal_embed=og, inpaint_gal_embed=ig,
              saliency_map=smap, mask_threshold_method="percent-density",
              percentiles=PCT, seed=3, include_zero_elements=False)
    host = TP.classified_as_inpainted_twin(HostOnly(), orig, inp, **kw)
    dev = TP.classified_as_inpainted_twin(twb, orig, inp, **kw)
    for a, b in zip(dev, host):
        np.testing.assert_array_equal(a, b)
    _cls_agree(dev, JP.classified_as_inpainted_twin(jwb, orig, inp, **kw))

    blur = TP.classified_as_inpainted_twin(twb, orig, inp,
                                           mask_blur_sigma=2.0, **kw)
    want = JP.classified_as_inpainted_twin(jwb, orig, inp,
                                           mask_blur_sigma=2.0, **kw)
    assert not blur[0][0]
    _cls_agree(blur, want)


@pytest.mark.parametrize("mono", [True, False])
def test_blend_programs_match_host_blends(mono):
    """Monotone families take the enter-count program, others the
    bit-packed chunks; both equal the host blends' embeddings exactly and
    JAX's at float32 tolerance."""
    jwb, twb = _nets()
    rng = np.random.RandomState(12 if mono else 11)
    orig, inp = _pair(12 if mono else 11)
    if mono:
        masks = TP.create_threshold_masks(_smap(rng, boost=False),
                                          "percent-density",
                                          percentiles=PCT, seed=5)
        assert np.all(masks[1:] >= masks[:-1])
    else:
        masks = rng.rand(37, 224, 224) > 0.5
    dev = twb.blend_embeddings(orig, inp, masks, norm=False)
    blends = np.where(masks[:, None], inp[None], orig[None])
    host = twb.embeddings(blends, norm=False)
    np.testing.assert_array_equal(dev, host.reshape(dev.shape))
    _emb_close(dev, jwb.blend_embeddings(orig, inp, masks, norm=False))


def test_launch_matches_sync_and_memo_is_safe():
    """launch + finish equals the synchronous call, and the content-hash
    upload memo never confuses two pairs of one shape."""
    _, twb = _nets(seed=3)

    def unit(seed):
        r = np.random.RandomState(seed)
        orig, inp = _pair(seed, np.float64)
        og, ig = _gal(twb, orig, inp)
        return dict(original_imT=orig, inpaint_imT=inp,
                    original_gal_embed=og, inpaint_gal_embed=ig,
                    saliency_map=_smap(r), percentiles=PCT, seed=3,
                    mask_threshold_method="percent-density",
                    include_zero_elements=False)

    u1, u2 = unit(20), unit(21)
    for u in (u1, u2, u1):  # revisit u1: the memo returns its own pair
        sync = TP.classified_as_inpainted_twin(twb, **u)
        launched = TP.launch_classified_as_inpainted_twin(twb, **u)()
        for a, b in zip(sync, launched):
            np.testing.assert_array_equal(a, b)
    assert len(twb._upload_memo) == 4  # 2 pairs x (orig, inp)


def test_counts_path_matches_mask_path():
    """The searchsorted enter-count plane classifies as the materialized
    [T,H,W] masks do (their counts come from masks.sum): same distances,
    same classes."""
    _, twb = _nets()
    rng = np.random.RandomState(5)
    orig, inp = _pair(5)
    smap = _smap(rng, boost=False)
    pct = np.unique(np.append(np.arange(0, 100, 3), [0, 100]))
    og, ig = _gal(twb, orig, inp)
    cls_c, pg_c, pr_c = TP.launch_classified_as_inpainted_twin(
        twb, orig, inp, og, ig, smap, "percent-density", percentiles=pct,
        seed=7, include_zero_elements=False)()
    plane, thr = TP._threshold_plane(smap, "percent-density",
                                     percentiles=pct, seed=7,
                                     include_zero_elements=False)
    masks = plane[None] > thr[:, None, None]
    e2 = twb.launch_blend_embeddings(orig, inp, masks, norm=True)()
    e2 = e2 / np.linalg.norm(e2, axis=1, keepdims=True)
    pr2 = np.linalg.norm(e2 - og, axis=1)
    pg2 = np.linalg.norm(e2 - ig, axis=1)
    np.testing.assert_array_equal(pg_c, pg2)
    np.testing.assert_array_equal(pr_c, pr2)
    np.testing.assert_array_equal(cls_c, pg2 < pr2)


def test_twin_cls_batch_matches_single_units_and_jax():
    """TwinClsBatch's one multi-map program returns what each map's own
    program returns; a launch after flush takes the single path; against
    the JAX package's TwinClsBatch at float32 tolerance."""
    jwb, twb = _nets()
    rng = np.random.RandomState(11)
    orig, inp = _pair(11)
    smaps = [_smap(rng, boost=False) for _ in range(3)]
    pct = np.unique(np.append(np.arange(0, 100, 4), [0, 100]))
    og, ig = _gal(twb, orig, inp)
    kw = dict(mask_threshold_method="percent-density", percentiles=pct,
              seed=7, include_zero_elements=False)

    def run(P, wb):
        batch = P.TwinClsBatch(wb, orig, inp, og, ig, **kw)
        fins = [batch.launch(s) for s in smaps]
        batch.flush()
        return [f() for f in fins], batch.launch(smaps[0])()

    multi, extra = run(TP, twb)
    jmulti, _ = run(JP, jwb)
    for s, got, want in zip(smaps, multi, jmulti):
        single = TP.launch_classified_as_inpainted_twin(
            twb, orig, inp, og, ig, s, **kw)()
        for a, b in zip(got, single):
            np.testing.assert_array_equal(a, b)
        _cls_agree(got, want)
    for a, b in zip(extra, multi[0]):
        np.testing.assert_array_equal(a, b)


def test_multi_pair_program_matches_single_pair_and_jax():
    jwb, twb = _nets()
    rng = np.random.RandomState(13)
    pairs = [_pair(13), _pair(14)]
    pct = np.unique(np.append(np.arange(0, 100, 4), [0, 100]))
    counts = []
    for _ in range(4):
        plane, thr = TP._threshold_plane(
            _smap(rng, boost=False), "percent-density", percentiles=pct,
            seed=7, include_zero_elements=False)
        counts.append(np.searchsorted(np.sort(thr), plane.ravel(),
                                      side="left").astype(np.uint8))
    counts, T = np.stack(counts), len(thr)
    pair_idx = np.array([0, 0, 1, 1], np.int32)
    args = ([p[0] for p in pairs], [p[1] for p in pairs], counts, pair_idx,
            T)
    got = twb.launch_blend_embeddings_counts_multi_pair(*args, norm=False)()
    assert got.shape == (4, T, 12)
    for m in range(4):
        o, i = pairs[pair_idx[m]]
        np.testing.assert_array_equal(
            got[m], twb.launch_blend_embeddings_counts(
                o, i, counts[m], T, norm=False)())
    _emb_close(got, jwb.launch_blend_embeddings_counts_multi_pair(
        *args, norm=False)())


def test_blend_launches_read_nothing_on_the_host(monkeypatch):
    """Until finish() runs, no launch of the blend+encode family reads a
    tensor on the host: every host read raises while TwinClsBatch
    launches and flushes, and while the single, bit-packed and
    multi-pair programs are launched."""
    _, twb = _nets()
    rng = np.random.RandomState(2)
    orig, inp = _pair(2)
    og, ig = _gal(twb, orig, inp)
    smaps = [_smap(rng) for _ in range(2)]
    masks = rng.rand(5, 224, 224) > 0.5
    kw = dict(mask_threshold_method="percent-density", percentiles=PCT,
              seed=7, include_zero_elements=False)

    def refuse(*a, **k):
        raise AssertionError("host read of a tensor on a launch path")

    with monkeypatch.context() as m:
        for name in ("item", "tolist", "numpy", "cpu", "__bool__",
                     "__int__", "__float__", "__array__"):
            m.setattr(torch.Tensor, name, refuse)
        batch = TP.TwinClsBatch(twb, orig, inp, og, ig, **kw)
        fins = [batch.launch(s) for s in smaps]
        batch.flush()
        fin_bits = twb.launch_blend_embeddings(orig, inp, masks)
        fin_pair = twb.launch_blend_embeddings_counts_multi_pair(
            [orig], [inp], np.zeros((2, 224 * 224), np.uint8), [0, 0], 101)
        with pytest.raises(AssertionError, match="host read"):
            fins[0]()
    assert all(len(f()[0]) == 101 for f in fins)
    assert fin_bits().shape == (5, 12) and fin_pair().shape == (2, 101, 12)
