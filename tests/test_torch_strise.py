"""The STRise slice as a whole, port against the JAX package, at small
size on the CPU.

Both sides get toy-net matchers (tests/fixtures.make_toy_wbnet and its
port twin with the same parameters) injected through ``net_dict``, the
mean-EBP prior, and the same injected mask grids and shifts (torch's
generator cannot reproduce the JAX PRNG).  The JAX side's fused-blend
branch runs its Pallas kernel in interpret mode.  Everything is float32:
scores are held to float32 rounding of a toy-net encode
taken in another order: 2.5e-7 absolute, four float32 steps at 1.0,
since a score is a difference of similarities near 1.  That is ~1e-4
of a toy score (~1e-3), and the min-max normalization of the map
amplifies it: maps are held to 1e-3 absolute.
"""

import functools
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from xfr_tpu.blackbox import pallas_blend
from xfr_tpu.blackbox.strise import STRise as JSTRise
from tests.fixtures import make_toy_wbnet
from tests.torch_fixtures import torch_twin

from xfr_torch.blackbox.strise import STRise

SCORE_ATOL = 2.5e-7


def _images():
    # textured, so that the blur fill differs from the probe under every
    # mask and no mask scores an exact 0 (a tie that rounding would break)
    rng = np.random.RandomState(8)
    probe = rng.randint(0, 256, (224, 224, 3)).astype(np.uint8)
    probe[32:80, 32:80] = 220
    gal = rng.randint(0, 256, (224, 224, 3)).astype(np.uint8)
    return probe, gal


def _kwargs(net_dict, **kw):
    probe, gal = _images()
    base = dict(probe=probe, refs=[probe], gallery=[gal],
                black_box="resnetv6_pytorch", net_dict=net_dict,
                prior_type="mean_ebp", num_masks=40, mask_scale=28,
                num_mask_elements=2, mask_fill_type="blur", seed=5,
                batch_size=16)
    base.update(kw)
    return base


@pytest.fixture(scope="module")
def nets():
    jwb = make_toy_wbnet(num_classes=4, seed=0, subtree_mode="norelu")
    twb = torch_twin(jwb)
    jdict = {("resnetv6_pytorch", 6): jwb, ("resnetv4_pytorch", None): jwb}
    tdict = {("resnetv6_pytorch", 6): twb, ("resnetv4_pytorch", None): twb}
    return jdict, tdict


def _grids_shifts(n=40, g=8, scale=28, seed=0):
    rng = np.random.RandomState(seed)
    grids = np.ones((n, g * g), np.float32)
    for i in range(n):
        grids[i, rng.choice(g * g, 2, replace=False)] = 0
    return (grids.reshape(n, g, g),
            rng.randint(0, scale, (n, 2)).astype(np.int32))


def _inject(st, grids, shifts, to_dev):
    st._grids_dev = to_dev(grids)
    st._shifts_dev = to_dev(shifts)
    st._masks_dev_cache = None
    st._masks_np = None


def _run_injected(st, grids, shifts, to_dev):
    """The evaluate() steps with the masks replaced by the given ones."""
    st.priors[st.prior_type]()
    _inject(st, grids, shifts, to_dev)
    st.apply_masks()
    st.score_masks()
    st.compute_saliency_map()
    return st


@pytest.fixture(scope="module")
def jax_result(nets):
    grids, shifts = _grids_shifts()
    st = JSTRise(**_kwargs(nets[0]))
    return _run_injected(st, grids, shifts, jnp.asarray)


@pytest.mark.parametrize("use_fused_blend", [False, True])
def test_slice_matches_jax(nets, jax_result, use_fused_blend, monkeypatch):
    grids, shifts = _grids_shifts()
    st = STRise(device="cpu", use_pallas_blend=use_fused_blend,
                **_kwargs(nets[1]))
    _run_injected(st, grids, shifts, torch.from_numpy)
    jst = jax_result
    if use_fused_blend:
        # the JAX side through its Pallas kernel (interpret mode)
        monkeypatch.setattr(pallas_blend, "fused_mask_blend_preprocess",
                            functools.partial(
                                pallas_blend.fused_mask_blend_preprocess,
                                interpret=True))
        jst = JSTRise(use_pallas_blend=True, **_kwargs(
            {k: make_toy_wbnet(num_classes=4, seed=0,
                               subtree_mode="norelu")
             for k in nets[0]}))
        _run_injected(jst, grids, shifts, jnp.asarray)

    prior, jprior = st.prior.numpy(), np.asarray(jst.prior)
    assert prior.shape == (224, 224)
    np.testing.assert_allclose(prior, jprior, rtol=1e-4,
                               atol=1e-5 * jprior.max())
    # float32 bilinear weights, computed as a resize here and as
    # interpolation matrices in JAX
    np.testing.assert_allclose(st.masks, np.asarray(jst.masks), rtol=0,
                               atol=4e-6)
    assert st.mask_scores.shape == (40,)
    np.testing.assert_allclose(st.mask_scores, jst.mask_scores, rtol=0,
                               atol=SCORE_ATOL)
    # every score is clear of 0 by far more than the tolerance, so the
    # selection (score > 0) must agree exactly
    assert np.abs(jst.mask_scores).min() > 100 * SCORE_ATOL
    np.testing.assert_array_equal(st.mask_scores > 0, jst.mask_scores > 0)
    assert st.saliency_map.shape == (224, 224)
    np.testing.assert_allclose(st.saliency_map, np.asarray(jst.saliency_map),
                               rtol=0, atol=1e-3)


def _spy_uploads(monkeypatch):
    """Record every tensor that goes through ``utils.device.to_device``
    (the upload caches emptied first) from the modules that upload, and
    fail a host array that ``torch.as_tensor`` or ``torch.tensor`` would
    place on a device itself: on the card that copy waits for the card."""
    from xfr_torch.blackbox import masks as M
    from xfr_torch.blackbox import strise as S
    from xfr_torch.models import resnet101 as R
    from xfr_torch.utils import device as D

    M._gaussian_kernel.cache_clear()
    R.mean_rgb.cache_clear()
    seen = []

    def spy(t, device):
        seen.append((tuple(t.shape), t.dtype))
        return D.to_device(t, device)

    def guard(make):
        def placed(data, *a, **kw):
            if kw.get("device") is not None and \
                    not isinstance(data, torch.Tensor):
                raise AssertionError("a host array placed on a device "
                                     "without utils.device.to_device")
            return make(data, *a, **kw)
        return placed

    for mod in (M, S, R):
        monkeypatch.setattr(mod, "to_device", spy)
    monkeypatch.setattr(torch, "as_tensor", guard(torch.as_tensor))
    monkeypatch.setattr(torch, "tensor", guard(torch.tensor))
    return seen


@pytest.mark.parametrize("use_fused_blend", [False, True])
def test_launch_evaluate_matches_evaluate(nets, use_fused_blend,
                                          monkeypatch):
    kw = _kwargs(nets[1], use_pallas_blend=use_fused_blend)
    st_a = STRise(device="cpu", **kw)
    st_a.evaluate()
    st_b = STRise(device="cpu", **kw)
    # the launch's host uploads (the refs and gallery are memoized by
    # st_a) all go through utils.device.to_device
    with monkeypatch.context() as mp:
        seen = _spy_uploads(mp)
        finish = st_b.launch_evaluate()
    for want in [((224, 224, 3), torch.uint8), ((3,), torch.float32),
                 ((40, 64), torch.float32), ((40, 2), torch.int32)]:
        assert want in seen, (want, seen)
    # the probe's, refs' and gallery's embeddings
    assert seen.count(((1, 12), torch.float32)) == 3, seen
    # the gaussians of the prior, of its downscale to the grid and of
    # the blur fill
    assert len({s for s, d in seen if len(s) == 1 and s != (3,)}) == 3
    smap = finish()
    np.testing.assert_array_equal(st_b.saliency_map, smap)
    if use_fused_blend:
        # the same finish as evaluate()'s: the same bits
        np.testing.assert_array_equal(smap, st_a.saliency_map)
    assert smap.flags.writeable and st_b.mask_scores.flags.writeable
    # the materialized branch finishes on the device (_select_combine_fn),
    # evaluate() on the host: the same float32 arithmetic, another order
    np.testing.assert_allclose(st_b.mask_scores, st_a.mask_scores, rtol=0,
                               atol=SCORE_ATOL)
    np.testing.assert_array_equal(st_b.mask_scores > 0, st_a.mask_scores > 0)
    np.testing.assert_allclose(smap, st_a.saliency_map, rtol=0, atol=1e-3)
    for name in ("masked_probe_ref_scores", "masked_probe_gallery_scores",
                 "original_probe_ref_scores",
                 "original_probe_gallery_scores"):
        np.testing.assert_allclose(getattr(st_b, name), getattr(st_a, name),
                                   rtol=0, atol=SCORE_ATOL, err_msg=name)
    assert np.isfinite(smap).all() and smap.min() >= 0 and smap.max() <= 1


def test_one_seed_gives_one_mask_set_on_both_branches(nets):
    """Grids, then shifts, from one generator in both branches: the same
    seed scores the same masks with or without the fused blend."""
    sts = [STRise(device="cpu", use_pallas_blend=f, **_kwargs(nets[1]))
           for f in (False, True)]
    for st in sts:
        st.priors[st.prior_type]()
        st.generate_masks()
    assert sts[0]._grids_dev is None and sts[1]._grids_dev is not None
    np.testing.assert_array_equal(sts[0].masks, sts[1].masks)


def test_external_matcher_matches_jax():
    probe, gal = _images()

    def bb_fn(probes, gallery):
        p = np.stack([np.asarray(x, np.float64)[32:80, 32:80].mean()
                      for x in probes])
        g = np.stack([np.asarray(x, np.float64)[32:80, 32:80].mean()
                      for x in gallery])
        return 1.0 - np.abs(p[:, None] - g[None, :]) / 255.0

    kw = dict(probe=probe, refs=[probe], gallery=[gal], black_box_fn=bb_fn,
              prior_type="uniform", num_masks=40, mask_scale=28,
              num_mask_elements=1, mask_fill_type="gray", seed=7)
    grids, shifts = _grids_shifts(seed=3)
    jst = _run_injected(JSTRise(**kw), grids, shifts, jnp.asarray)
    st = _run_injected(STRise(device="cpu", **kw), grids, shifts,
                       torch.from_numpy)
    # float32 blends rounded in another order, averaged by bb_fn
    np.testing.assert_allclose(st.mask_scores, jst.mask_scores, rtol=1e-6,
                               atol=1e-7)
    # The map is normalized by its range, so score gaps of about 1e-7 grow
    # at a pixel: one of 50,176 pixels differs by 1.68e-6 (4.1e-5
    # relative) on a map whose max is 1.0, measured on the CPU (the
    # rounding follows the host's float32 kernels).  Held at 1e-5 of the
    # map's max.
    want = np.asarray(jst.saliency_map)
    np.testing.assert_allclose(st.saliency_map, want, rtol=1e-5,
                               atol=1e-5 * want.max())
    # masked probes and apply_masks_using_image on the host
    fill = np.zeros((224, 224, 3), np.float32)
    out = st.apply_masks_using_image(fill)
    # masks agree to 4e-6 (see test_slice_matches_jax), times 255
    np.testing.assert_allclose(out, jst.apply_masks_using_image(fill),
                               rtol=0, atol=1.1e-3)
    # and the port's own launch/finish split of the external path
    st2 = STRise(device="cpu", **kw)
    st3 = STRise(device="cpu", **kw)
    st3.evaluate()
    np.testing.assert_allclose(st2.launch_evaluate()(), st3.saliency_map,
                               rtol=1e-6)


def test_embed_memo_reuses_collection_embeds(nets):
    twb = nets[1][("resnetv6_pytorch", 6)]
    twb._bb_embed_memo = {}
    probe, gal = _images()
    kw = _kwargs(nets[1], prior_type="uniform", num_masks=16,
                 refs=[gal[::-1].copy()])
    st1 = STRise(device="cpu", **kw)
    st1.evaluate()
    assert len(twb._bb_embed_memo) == 3  # refs, gallery, [probe]
    st2 = STRise(device="cpu", **kw)
    st2.evaluate()
    assert len(twb._bb_embed_memo) == 3
    np.testing.assert_array_equal(st1.mask_scores, st2.mask_scores)
    np.testing.assert_array_equal(st2._embed_collection_memo(twb, [gal]),
                                  st2._embed_collection(twb, [gal]))


def test_entry_points_refuse_missing_card_and_mesh(nets):
    from xfr_torch.models import create_wbnet
    from xfr_torch.models.convert import params_from_jax, \
        params_from_state_dict
    from xfr_torch.models.resnet101 import preprocess_resnet101

    kw = _kwargs(nets[1])
    with pytest.raises(ValueError, match="DeviceMesh with a 'dp' dim"):
        STRise(device="cpu", mesh=object(), **kw)
    assert STRise(device=None, use_gpu=False, **kw).device.type == "cpu"
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        STRise(**kw)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_wbnet("resnetv6_pytorch")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_jax({"fc": {"w": np.zeros(2)}})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_state_dict({"fc": {"w": (2,)}},
                               {"fc.weight": np.zeros(2)})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        preprocess_resnet101(np.zeros((8, 8, 3), np.uint8))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_wbnet("lightcnn")
    with pytest.raises(NotImplementedError, match="does not implement"):
        create_wbnet("no_such_net", device="cpu")
    from xfr_torch.cli import run_eval
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_eval.main(["--cache-dir", os.devnull, "--net",
                       "resnetv6_pytorch"])


def test_port_imports_no_jax():
    """Every module of xfr_torch, as pkgutil.walk_packages finds them,
    chip_smoke and bench_torch import without JAX, jaxlib or xfr_tpu."""
    code = ("import importlib, pkgutil, sys, xfr_torch; "
            "names = [m.name for m in pkgutil.walk_packages("
            "xfr_torch.__path__, 'xfr_torch.')] + ['chip_smoke', "
            "'bench_torch']; "
            "[importlib.import_module(n) for n in names]; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'xfr_tpu')]; "
            "assert not bad, bad; "
            "assert len(names) > 30, names")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-c", code], cwd=root, check=True,
                   timeout=120)


def _senet_pair():
    """SENet-50-256 at one block a stage (full widths) on the benchmark's
    seeded weights, its squeeze-excite gates calibrated to spread over
    (0, 1): (the JAX package's graph, encode tensor and parameters, the
    port's Whitebox over the same values)."""
    from xfr_bench import harness as H
    from xfr_bench.reference import senet50_256 as RSE
    from xfr_tpu.models import vggface2 as JV2

    cfg = H.config("senet50_256")
    cfg["layers"] = [1, 1, 1, 1]
    params = H.make_weights(RSE.param_shapes(cfg), 2 ** 36 + 5, "cpu")
    g = torch.Generator().manual_seed(11)
    RSE.calibrate_gates(params, cfg, torch.randint(
        0, 256, (2, 224, 224, 3), generator=g, dtype=torch.uint8),
        cfg["se_logit_std"])
    with pytest.MonkeyPatch.context() as m:
        # the JAX builder's stages at one block each
        m.setattr(JV2, "_STAGES", tuple((s[0], 1) + s[2:]
                                        for s in JV2._STAGES))
        jg, jshapes, jenc = JV2.build_senet50_256()
    assert jshapes == RSE.param_shapes(cfg)
    jp = {k: {kk: jnp.asarray(vv.numpy()) for kk, vv in v.items()}
          for k, v in params.items()}
    return (jg, jenc, jp), cfg["program"].program(cfg, params, "cpu")


def test_senet_matcher_matches_jax():
    """STRise over SENet-50-256 (``black_box="senet50_256"``: the port's
    chunk scorer, blends preprocessed with the VGGFace2 mean) against the
    JAX package's STRise scoring through a ``black_box_fn`` on the JAX
    SENet (its float32 blends preprocessed as ``preprocess_vggface2_batch``
    does, L2-normalized embeddings, ``make_bb_score_fn``'s similarity),
    the same weights, probe, masks and seed: mask scores and map within
    the ResNet slice's tolerances (measured on the CPU: 1.5e-7 and
    2.5e-4)."""
    from xfr_tpu.ebp import interpreter as JI
    from xfr_tpu.models import vggface2 as JV2

    (jg, jenc, jp), twb = _senet_pair()
    twb.batch_size = 4  # the probe's, refs' and gallery's encodes

    def jax_bb_fn(probes, gallery):
        def embed(images):
            x = JV2.preprocess_vggface2_batch(jnp.asarray(
                np.stack([np.asarray(im, np.float32) for im in images])))
            e = JI.forward_clean(jg, jp, x)[jenc].reshape(len(images), -1)
            return e / jnp.linalg.norm(e, axis=1, keepdims=True)

        pe, ge = embed(probes), embed(gallery)
        return np.asarray(1.0 - 0.5 * jnp.linalg.norm(
            pe[:, None] - ge[None], axis=2))

    probe, gal = _images()
    rng = np.random.RandomState(4)
    ref = np.clip(probe.astype(int) + rng.randint(-20, 21, probe.shape), 0,
                  255).astype(np.uint8)
    kw = dict(probe=probe, refs=[ref], gallery=[gal, probe[::-1].copy()],
              prior_type="uniform", num_masks=40, mask_scale=28,
              num_mask_elements=2, mask_fill_type="blur", seed=5,
              batch_size=16)
    grids, shifts = _grids_shifts()
    jst = _run_injected(JSTRise(black_box_fn=jax_bb_fn, **kw), grids,
                        shifts, jnp.asarray)
    st = _run_injected(
        STRise(device="cpu", black_box="senet50_256",
               net_dict={("senet50_256", 6): twb}, **kw),
        grids, shifts, torch.from_numpy)
    assert st.mask_scores.shape == (40,)
    np.testing.assert_allclose(st.mask_scores, jst.mask_scores, rtol=0,
                               atol=SCORE_ATOL)
    assert np.abs(jst.mask_scores).min() > 100 * SCORE_ATOL
    np.testing.assert_array_equal(st.mask_scores > 0, jst.mask_scores > 0)
    np.testing.assert_allclose(st.saliency_map, np.asarray(jst.saliency_map),
                               rtol=0, atol=1e-3)
