"""The port's whitebox engine against the JAX package: the batched
mean-EBP, the contrastive family, the batched weighted-subtree path, the
compute-dtype knobs, the 4-map mix on reduced-depth ResNet-101 and the
ResNet entries of ``demo/whitebox_goldens.npz``.

The engine's batched paths run float32 on both sides (the JAX package's
``_pad_probe_batch`` casts to float32), so the toy-net maps are held at
rtol 1e-4 / atol 1e-6 (test_batched_ebp.py's tolerance) and the subtree
scores at rtol 1e-5.  Weights are the JAX net's, carried across.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from xfr_tpu.ebp.engine import Whitebox as JWhitebox
from xfr_tpu.ebp.engine import WhiteboxNetwork as JNet
from xfr_tpu.models import common as JC
from xfr_tpu.models import resnet101 as JR
from tests.fixtures import make_toy_wbnet
from tests.torch_fixtures import jax_params_np, torch_twin

from xfr_torch.ebp.engine import Whitebox, WhiteboxNetwork
from xfr_torch.models import resnet101 as TR
from xfr_torch.models.convert import params_from_jax

RTOL, ATOL = 1e-4, 1e-6


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def _toy_batch(mode="all", seed=5, B=3, num_classes=4, **wb_kw):
    """JAX toy net and its port twin with one interleaved batch
    classifier installed on each, and B float32 probes."""
    jwb = make_toy_wbnet(num_classes=num_classes, seed=seed,
                         subtree_mode=mode)
    twb = torch_twin(jwb)
    for k, v in wb_kw.items():
        setattr(twb, k, v)
    rng = np.random.RandomState(seed + 6)
    probes = rng.rand(B, 3, 224, 224).astype(np.float32)
    ems = rng.rand(B, 12).astype(np.float32)
    ens = rng.rand(B, 12).astype(np.float32)
    ems /= np.linalg.norm(ems, axis=1, keepdims=True)
    ens /= np.linalg.norm(ens, axis=1, keepdims=True)
    jwb.set_triplet_classifier_batch(ems, ens)
    twb.set_triplet_classifier_batch(ems, ens)
    return jwb, twb, probes


# ---------------------------------------------------------------------------
# Mean-EBP and the contrastive family
# ---------------------------------------------------------------------------


def test_ebp_batch_matches_jax():
    jwb, twb, probes = _toy_batch()
    want = jwb.ebp_batch(jnp.asarray(probes))
    got = twb.ebp_batch(probes)
    assert len(got) == 3 and got[0].shape == (56, 56)
    for a, b in zip(got, want):
        _close(a, b)
    for a, b in zip(twb.ebp_batch(probes, mwp=True),
                    jwb.ebp_batch(jnp.asarray(probes), mwp=True)):
        _close(a, b, atol=1e-6 * np.abs(b).max())


@pytest.mark.parametrize("truncated", [False, True])
def test_single_probe_contrastive_matches_jax(truncated):
    jwb = make_toy_wbnet(num_classes=5, seed=3, subtree_mode="all")
    twb = torch_twin(jwb)
    probe = np.random.RandomState(3).rand(1, 3, 224, 224).astype(np.float32)
    if truncated:
        want = jwb.truncated_contrastive_ebp(jnp.asarray(probe), 2, 3, 20)
        got = twb.truncated_contrastive_ebp(probe, 2, 3, 20)
    else:
        want = jwb.contrastive_ebp(jnp.asarray(probe), 2, 3)
        got = twb.contrastive_ebp(probe, 2, 3)
    assert got.shape == (56, 56) and got.max() > 0
    _close(got, want)


@pytest.mark.parametrize("truncate_percent", [None, 20])
def test_contrastive_batch_matches_jax(truncate_percent):
    jwb, twb, probes = _toy_batch(seed=1)
    want = jwb.contrastive_ebp_batch(jnp.asarray(probes), truncate_percent)
    got = twb.contrastive_ebp_batch(probes, truncate_percent)
    for a, b in zip(got, want):
        _close(a, b)


def test_contrastive_both_matches_jax_and_launch_equals_sync():
    """The fused both-maps launch against JAX, against the two separate
    batched calls (rtol 1e-5 / atol 1e-7, test_batched_ebp.py's), and its
    launch + finish() against the synchronous call (equal)."""
    jwb, twb, probes = _toy_batch(seed=1)
    jc, jt = jwb.contrastive_ebp_batch_both(jnp.asarray(probes), 20)
    tc, tt = twb.contrastive_ebp_batch_both(probes, 20)
    for a, b in zip(tc + tt, jc + jt):
        _close(a, b)
    sep = (twb.contrastive_ebp_batch(probes)
           + twb.contrastive_ebp_batch(probes, truncate_percent=20))
    for a, b in zip(tc + tt, sep):
        _close(a, b, rtol=1e-5, atol=1e-7)
    lc, lt = twb.launch_contrastive_ebp_batch_both(probes, 20)()
    for a, b in zip(lc + lt, tc + tt):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# Weighted subtree EBP, probe-batched
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("gating", [True, False])
@pytest.mark.parametrize("mode", ["norelu", "all"])
def test_weighted_subtree_batch_matches_jax(mode, gating):
    """k_subtree_valid equal, scores rtol 1e-5, merged maps rtol 1e-4 /
    atol 1e-6; launch + finish() equals the synchronous call."""
    jwb, twb, probes = _toy_batch(mode="affineonly")
    kw = dict(topk=3, subtree_mode=mode, do_mated_similarity_gating=gating)
    want = jwb.weighted_subtree_ebp_batch(jnp.asarray(probes), **kw)
    got = twb.weighted_subtree_ebp_batch(probes, **kw)
    launched = twb.launch_weighted_subtree_ebp_batch(probes, **kw)()
    for (s_t, m_t, sc_t, k_t), (s_j, _, sc_j, k_j), (s_l, _, sc_l, k_l) in \
            zip(got, want, launched):
        assert k_t == k_j == k_l and len(k_t) >= 1
        assert m_t == []
        np.testing.assert_allclose(sc_t, sc_j, rtol=1e-5)
        _close(s_t, s_j)
        assert sc_l == sc_t
        np.testing.assert_array_equal(s_l, s_t)
    assert twb.ebp_subtree_mode() == "affineonly"  # restored after launch


@pytest.mark.parametrize("do_max", [False, True])
def test_ranking_pass_and_sweep_match_jax(do_max):
    """The ranking pass's scores, argmaxes and injection values, then the
    fused sweep+select+merge on them, against the JAX programs."""
    jwb, twb, probes = _toy_batch(mode="norelu", seed=7)
    jwb._ebp_subtree_mode = twb._ebp_subtree_mode = "norelu"
    js, ji, jv = jwb._wsebp_grad_batch_fn()(jwb.net.params,
                                            jnp.asarray(probes), gating=True)
    ts, ti, tv = twb._wsebp_grad_batch_fn()(twb.net.params,
                                            torch.from_numpy(probes), True)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5,
                               atol=1e-9)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5,
                               atol=1e-9)
    jm, jsel = jwb._wsebp_sweep_select_scan_fn(3, do_max)(
        jwb.net.params, jnp.asarray(probes), ji.astype(jnp.int32), jv, js)
    tm, tsel = twb._wsebp_sweep_select_scan_fn(3, do_max)(
        twb.net.params, torch.from_numpy(probes), ti.to(torch.int32), tv,
        ts)
    np.testing.assert_array_equal(tsel.numpy(), np.asarray(jsel))
    _close(tm.numpy(), np.asarray(jm), atol=1e-6 * float(np.max(jm)))


@pytest.mark.parametrize("chunk", [1, 3])
def test_probe_batched_sweep_equals_scan(chunk):
    """One [rows, B, ...] walk equals the chunked loop (the JAX scan) at
    wsebp_probe_chunk 1 and 3: selection equal, maps rtol 1e-5 /
    atol 1e-7 (test_wsebp_sweep.py's)."""
    _, twb, probes = _toy_batch(seed=9)
    x = torch.from_numpy(probes)
    s, i, v = twb._wsebp_grad_batch_fn()(twb.net.params, x, True)
    i = i.to(torch.int32)
    twb.wsebp_probe_chunk = chunk
    m_scan, s_scan = twb._wsebp_sweep_select_scan_fn(3, False)(
        twb.net.params, x, i, v, s)
    m_bat, s_bat = twb._wsebp_sweep_select_batch_fn(3, False)(
        twb.net.params, x, i, v, s)
    np.testing.assert_array_equal(s_bat.numpy(), s_scan.numpy())
    np.testing.assert_allclose(m_bat.numpy(), m_scan.numpy(), rtol=1e-5,
                               atol=1e-7)


def test_uint8_fused_finish_matches_jax():
    """ebp_version 5: the merged map goes through the uint8 branch of the
    fused finish (min-max to 0..255, PIL blur, again 0..255); maps equal
    up to one uint8 step.  _scale_normalized equals the JAX package's."""
    jwb0 = make_toy_wbnet(num_classes=4, seed=5, subtree_mode="all")
    jwb = JWhitebox(jwb0.net, ebp_version=5, ebp_subtree_mode="all",
                    eps=jwb0.eps)
    twb = torch_twin(jwb0)
    twb.ebp_ver, twb.convert_saliency_uint8 = 5, True
    rng = np.random.RandomState(2)
    probes = rng.rand(2, 3, 224, 224).astype(np.float32)
    e = rng.rand(4, 12).astype(np.float32)
    for wb in (jwb, twb):
        wb.set_triplet_classifier_batch(e[:2], e[2:])
    want = jwb.weighted_subtree_ebp_batch(jnp.asarray(probes), topk=3,
                                          subtree_mode="all")
    got = twb.weighted_subtree_ebp_batch(probes, topk=3, subtree_mode="all")
    for (s_t, _, _, k_t), (s_j, _, _, k_j) in zip(got, want):
        assert k_t == k_j and s_t.dtype == np.uint8
        assert np.abs(s_t.astype(int) - s_j.astype(int)).max() <= 1
    vals = [0.3, -1.5, 2.25, 0.0]
    np.testing.assert_array_equal(twb._scale_normalized(vals),
                                  jwb._scale_normalized(vals))


def test_launch_paths_read_nothing_on_the_host(monkeypatch):
    """Until finish() runs, no launch reads a tensor on the host: every
    host read of a tensor raises while the launches are made."""
    _, twb, probes = _toy_batch(mode="norelu", seed=4)
    x = torch.from_numpy(probes)
    Pn = torch.ones((3, twb.net.num_classes()))

    def refuse(*a, **k):
        raise AssertionError("host read of a tensor on a launch path")

    with monkeypatch.context() as m:
        for name in ("item", "tolist", "numpy", "cpu", "__bool__",
                     "__int__", "__float__", "__array__"):
            m.setattr(torch.Tensor, name, refuse)
        twb._ebp_pooled_fn()(twb.net.params, x, Pn)
        finish_ct = twb.launch_contrastive_ebp_batch_both(x, 20)
        finish_ws = twb.launch_weighted_subtree_ebp_batch(
            x, topk=32, subtree_mode="norelu")
        with pytest.raises(AssertionError, match="host read"):
            finish_ws()
    contr, trunc = finish_ct()
    assert len(contr) == len(trunc) == 3
    assert len(finish_ws()) == 3


def test_refusals():
    """float16 cannot carry eps=1e-16 in the sweep; the probe batch must
    match the batch classifier.  return_subtree_maps=True, refused before
    the per-probe path was ported, now runs and returns each probe's
    selected subtree maps."""
    _, twb, probes = _toy_batch()
    twb.eps = 1e-16
    twb.wsebp_dtype = torch.float16
    with pytest.raises(ValueError, match="float16"):
        twb.weighted_subtree_ebp_batch(probes, topk=3)
    twb.wsebp_dtype = torch.bfloat16
    assert twb._wsebp_dtype == torch.bfloat16
    with pytest.raises(ValueError, match="set_triplet_classifier_batch"):
        twb.ebp_batch(probes[:2])
    twb.wsebp_dtype = None
    out = twb.weighted_subtree_ebp_batch(probes, topk=3,
                                         return_subtree_maps=True)
    assert len(out) == 3
    for smap, maps, scores, ks in out:
        assert smap.shape == (56, 56) and len(maps) == len(ks) >= 1
        assert len(scores) == len(ks)


# ---------------------------------------------------------------------------
# Compute dtypes (the gates of tests/test_compute_dtype.py, on the port)
# ---------------------------------------------------------------------------


def test_wsebp_dtype_bf16_quality_gate():
    """wsebp_dtype=bfloat16 keeps float32 everywhere but the candidate
    sweep: identical ranking scores (rtol 1e-6), overlapping selections
    (at least 2 of 3), merged map correlation > 0.98."""
    res = {}
    for dt in (None, torch.bfloat16):
        jwb, twb, probes = _toy_batch(mode="all", seed=2, B=1,
                                      num_classes=5, wsebp_dtype=dt)
        res[dt] = twb.weighted_subtree_ebp_batch(probes, topk=3,
                                                 subtree_mode="all")[0]
    (m32, _, sc32, k32), (m16, _, sc16, k16) = res[None], res[torch.bfloat16]
    np.testing.assert_allclose(sc16, sc32, rtol=1e-6)
    assert len(set(k32) & set(k16)) >= 2, (k32, k16)
    assert np.isfinite(m16).all()
    assert np.corrcoef(m32.ravel(), m16.ravel())[0, 1] > 0.98


def test_contrastive_dtype_pin_makes_bf16_safe():
    """compute_dtype=bfloat16 with contrastive_dtype=float32 reproduces the
    all-float32 contrastive and truncated maps exactly, single-probe and
    batched, while mean-EBP runs bfloat16."""
    jwb, t32, probes = _toy_batch(mode="all", seed=3, B=2)
    tmx = torch_twin(jwb)
    tmx.compute_dtype, tmx.contrastive_dtype = torch.bfloat16, torch.float32
    tmx.set_triplet_classifier_batch(*[
        t32.net.params["fc2"]["w"][i::2].numpy() for i in (0, 1)])
    np.testing.assert_array_equal(tmx.contrastive_ebp(probes[:1], 0, 1),
                                  t32.contrastive_ebp(probes[:1], 0, 1))
    np.testing.assert_array_equal(
        tmx.truncated_contrastive_ebp(probes[:1], 0, 1, 20),
        t32.truncated_contrastive_ebp(probes[:1], 0, 1, 20))
    for a, b in zip(sum(tmx.contrastive_ebp_batch_both(probes, 20), []),
                    sum(t32.contrastive_ebp_batch_both(probes, 20), [])):
        np.testing.assert_array_equal(a, b)
    m16, m32 = tmx.ebp_batch(probes), t32.ebp_batch(probes)
    assert not all(np.array_equal(a, b) for a, b in zip(m16, m32))
    assert min(np.corrcoef(a.ravel(), b.ravel())[0, 1]
               for a, b in zip(m16, m32)) > 0.99


# ---------------------------------------------------------------------------
# Reduced-depth ResNet-101: the 4-map mix
# ---------------------------------------------------------------------------


def test_four_map_mix_reduced_resnet101_matches_jax():
    """bench.py's whitebox mix (mean-EBP under an all-ones cotangent, the
    em/2500 triplet contrastive pair, weighted-subtree top-32 in norelu
    mode) on ResNet-101 at full widths with one block per stage, 16
    classes, B=2, float32 on both sides.  Mean-EBP and weighted-subtree
    maps within 1e-4 of the map's maximum, equal subtree selections and
    scores at rtol 5e-5; the contrastive maps, differences of two
    near-equal distributions, at correlation >= 0.999."""
    nc, B = 16, 2
    graph, shapes, enc = JR.build_resnet101(num_classes=nc,
                                            layers=(1, 1, 1, 1))
    params = JC.init_params(shapes, seed=0)
    jwb = JWhitebox(JNet(graph, params, encode_tensor=enc,
                         classifier_pname="fc2", num_classes=nc),
                    ebp_version=6, ebp_subtree_mode="norelu")
    tgraph, _, tenc = TR.build_resnet101(num_classes=nc, layers=(1, 1, 1, 1))
    twb = Whitebox(WhiteboxNetwork(
        tgraph, params_from_jax(jax_params_np(params, np.float32),
                                device="cpu"),
        encode_tensor=tenc, classifier_pname="fc2", num_classes=nc),
        ebp_version=6, ebp_subtree_mode="norelu")
    rng = np.random.RandomState(0)
    probes = (rng.rand(B, 3, 224, 224) * 50).astype(np.float32)
    e = np.asarray(jwb.encode(jnp.asarray(rng.rand(2, 3, 224, 224) * 50,
                                          jnp.float32)))
    em, en = e[0] / np.linalg.norm(e[0]), e[1] / np.linalg.norm(e[1])

    def mix(wb, x, Pn):
        wb.net.reset_classifier()
        pooled, _ = wb._ebp_pooled_fn()(wb.net.params, x, Pn)
        mean = [wb._mwp_to_saliency(np.asarray(pooled)[i]) for i in range(B)]
        wb.set_triplet_classifier_batch(np.tile(em / 2500.0, (B, 1)),
                                        np.tile(en / 2500.0, (B, 1)))
        contr, trunc = wb.launch_contrastive_ebp_batch_both(x, 20)()
        wb.set_triplet_classifier_batch(np.tile(em, (B, 1)),
                                        np.tile(en, (B, 1)))
        ws = wb.launch_weighted_subtree_ebp_batch(
            x, topk=32, subtree_mode="norelu")()
        return mean, contr, trunc, ws

    ones = np.ones((B, nc), np.float32)
    jm, jc, jt, jws = mix(jwb, jnp.asarray(probes), jnp.asarray(ones))
    tm, tc, tt, tws = mix(twb, torch.from_numpy(probes),
                          torch.from_numpy(ones))
    for a, b in zip(tm, jm):
        assert a.shape == (112, 112)
        np.testing.assert_allclose(a, b, atol=1e-4 * b.max(), rtol=0)
    for a, b in zip(tc + tt, jc + jt):
        assert np.corrcoef(a.ravel(), b.ravel())[0, 1] >= 0.999
    for (s_t, _, sc_t, k_t), (s_j, _, sc_j, k_j) in zip(tws, jws):
        assert k_t == k_j and len(k_t) >= 30
        # float32 scores, each reduced along a reduced-depth walk whose
        # sums the two frameworks reassociate differently: 2 of 32 differ
        # by 1.08e-5 relative (2.2e-10 absolute) on one CPU, within 1e-5
        # on another.  Held at rtol 5e-5.
        np.testing.assert_allclose(sc_t, sc_j, rtol=5e-5)
        np.testing.assert_allclose(s_t, s_j, atol=1e-4 * s_j.max(), rtol=0)


# ---------------------------------------------------------------------------
# demo/whitebox_goldens.npz, ResNet entries
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def resnet_golden():
    """The goldens, the JAX package's create_wbnet("resnetv4_pytorch")
    weights as numpy, its preprocessed demo face, and the triplet
    classifier's encodings from the JAX net, as the goldens were made (the
    maps amplify any difference in the classifier)."""
    from tests.test_demo_goldens import GOLDEN_PATH, _demo_face_arr
    from xfr_tpu.models import create_wbnet as jax_create_wbnet

    face = _demo_face_arr()
    jwb = jax_create_wbnet("resnetv4_pytorch")
    x, mate, nonmate = (
        np.array(jwb.convert_from_numpy(f), np.float32)
        for f in (face, np.roll(face, 3, axis=0), 255 - face))
    em, en = (np.asarray(jwb.encode(jnp.asarray(v)))[0]
              for v in (mate, nonmate))
    return dict(golden=dict(np.load(GOLDEN_PATH)), x=x, mate=mate, em=em,
                en=en, params=jax_params_np(jwb.net.params, np.float32),
                n=jwb.net.num_classes(), ebp_ver=jwb.ebp_ver,
                mode=jwb.ebp_subtree_mode())


def _golden_whitebox(rg, dtype):
    graph, _, enc = TR.build_resnet101()
    params = {k: {kk: vv.astype(dtype) for kk, vv in v.items()}
              for k, v in rg["params"].items()}
    return Whitebox(WhiteboxNetwork(
        graph, params_from_jax(params, device="cpu"), encode_tensor=enc,
        classifier_pname="fc2", num_classes=rg["n"]),
        ebp_version=rg["ebp_ver"], ebp_subtree_mode=rg["mode"])


# |port - golden| limit per contrastive map, as a fraction of the golden's
# max: the measured gaps (4.7e-4, 4.6e-4, 1.09e-2) with about 4x and 2x of
# room.  Where the gaps come from is pinned by the test after this one.
GOLDEN_CONTRASTIVE_ATOL = {"contrastive_ebp": 2e-3,
                           "truncated_contrastive_ebp": 2e-3,
                           "contrastive_triplet_ebp": 2e-2}


def test_resnet_goldens(resnet_golden):
    """The five ResNet entries of demo/whitebox_goldens.npz (ebp,
    mean_ebp, contrastive_ebp, truncated_contrastive_ebp,
    contrastive_triplet_ebp) from the port, with the weights of the JAX
    package's create_wbnet("resnetv4_pytorch") carried across and its
    preprocessed demo face as input.

    ebp and mean_ebp hold test_demo_goldens.py's tolerance (rtol 1e-3,
    atol 1e-5 of the golden's max).  The three contrastive maps are
    relu(mate - nonmate) of two unit-mass MWPs that nearly cancel (they
    differ by 0.3% of their max for classes 0 and 100, by 2.1e-5 for the
    triplet), and the goldens carry the JAX program's float32 rounding of
    that combine (see the next test).  Each is held at its own limit,
    GOLDEN_CONTRASTIVE_ATOL, and at a correlation of at least 0.9998."""
    rg = resnet_golden
    golden, x, n = rg["golden"], rg["x"], rg["n"]
    wb = _golden_whitebox(rg, np.float32)
    P0 = np.zeros((1, n), np.float32)
    P0[0, 0] = 1.0
    maps = {"ebp": wb.ebp(x, P0),
            "mean_ebp": wb.ebp(x, np.full((1, n), 1.0 / n, np.float32)),
            "contrastive_ebp": wb.contrastive_ebp(x, 0, 100),
            "truncated_contrastive_ebp": wb.truncated_contrastive_ebp(
                x, 0, 100, percentile=20)}
    em, en = rg["em"], rg["en"]
    np.testing.assert_allclose(wb.encode(rg["mate"]).numpy()[0], em,
                               rtol=1e-4, atol=1e-4 * np.abs(em).max())
    wb.net.set_triplet_classifier(em / 2500.0, en / 2500.0)
    maps["contrastive_triplet_ebp"] = wb.contrastive_ebp(x, 0, 1)
    for name, m in maps.items():
        g = golden[name]
        assert m.shape == g.shape, (name, m.shape, g.shape)
        if name in GOLDEN_CONTRASTIVE_ATOL:
            np.testing.assert_allclose(
                m, g, rtol=0, atol=GOLDEN_CONTRASTIVE_ATOL[name] * g.max(),
                err_msg=name)
            assert np.corrcoef(m.ravel(), g.ravel())[0, 1] >= 0.9998, name
        else:
            np.testing.assert_allclose(m, g, rtol=1e-3,
                                       atol=1e-5 * max(g.max(), 1e-12),
                                       err_msg=name)


def _mass_mask_f64(m, percentile):
    """_percentile_mass_mask's definition in float64, by sorting: the
    smallest t whose sub-t mass reaches ``percentile``% of the total."""
    flat = np.sort(m.ravel())
    cs = np.cumsum(flat)
    return m >= flat[np.searchsorted(cs, percentile / 100.0 * cs[-1])]


def test_resnet_golden_contrastive_gap_is_jax_float32_combine(
        resnet_golden):
    """Where the contrastive goldens' gap comes from.  The port's walks run
    in float64 at full depth (the other tests hold them to the JAX
    package's at float64) and are cast to float32 as both programs cast
    them.  On those same MWPs:

      * the port's float32 combine (``_contrastive_combine``) lies within
        1e-4 (classes 0/100) and 3e-3 (triplet) of the saliency max from
        a float64 combine (measured 2.1e-5, 2.0e-5, 7.7e-4);
      * the JAX package's combine (engine.py:491-498, jitted here as
        there) lies within 5e-4 and 6e-3 of the goldens it wrote
        (measured 1.1e-4, 1.1e-4, 2.2e-3), but 5.5e-4 and 8.4e-3 from the
        float64 combine.

    So the goldens carry XLA's float32 rounding of the combine, amplified
    by the mate/nonmate cancellation, and the port's own gap to them is
    that rounding.  ``pytest -s`` prints the three gaps of each map."""
    import jax
    from functools import partial
    from xfr_torch.ebp import interpreter as TI
    from xfr_torch.ebp.engine import _contrastive_combine
    from xfr_tpu.ebp.engine import _percentile_mass_mask as jax_mass_mask

    rg = resnet_golden
    wb = _golden_whitebox(rg, np.float64)
    eps = wb.eps
    graph = wb.net.graph
    kk = graph.n_events - 2

    @partial(jax.jit, static_argnums=2)
    def jax_combine(P, percentile, truncate):
        mate = P[0] / jnp.maximum(P[0].sum(), eps)
        nonmate = P[1] / jnp.maximum(P[1].sum(), eps)
        if truncate:
            mask = jax_mass_mask(mate, percentile)
            diff = jnp.maximum(mask * mate - mask * nonmate, 0)
        else:
            diff = jnp.maximum(mate - nonmate, 0)
        return diff.sum(axis=1)[0]

    def mwp_pair(k_mate, k_nonmate):
        params, values, posvals = wb._capture(
            wb.net.params, torch.from_numpy(rg["x"].astype(np.float64)))
        cot = torch.zeros((2, 1, wb.net.num_classes()), dtype=torch.float64)
        cot[0, 0, k_mate] = cot[1, 0, k_nonmate] = 1.0
        return TI.ebp_backward(
            graph, params, values, posvals, cot, subtree_mode=rg["mode"],
            eps=eps, keep=(kk,))[kk].float()

    pair = mwp_pair(0, 100)
    em, en = (v / 2500.0 for v in (rg["em"], rg["en"]))
    wb.net.set_triplet_classifier(em.astype(np.float64),
                                  en.astype(np.float64))
    cases = [("contrastive_ebp", pair, False, 1e-4, 5e-4),
             ("truncated_contrastive_ebp", pair, True, 1e-4, 5e-4),
             ("contrastive_triplet_ebp", mwp_pair(0, 1), False, 3e-3, 6e-3)]
    for name, P, truncate, port_lim, jax_lim in cases:
        kind = "truncated" if truncate else "contrastive"
        port = _contrastive_combine(P, eps, 20.0, (kind,))[0][0].numpy()
        jx = np.asarray(jax_combine(jnp.asarray(P.numpy()),
                                    jnp.float32(20.0), truncate))
        P64 = P.double().numpy()
        mate, nonmate = (q / q.sum() for q in P64)
        mask = _mass_mask_f64(mate, 20.0) if truncate else 1.0
        exact = np.maximum(mask * mate - mask * nonmate, 0).sum(axis=1)[0]
        port, jx, exact = (wb._mwp_to_saliency(v.astype(np.float32))
                           for v in (port, jx, exact))
        gmax = rg["golden"][name].max()
        print(name, {k: float(np.abs(a - b).max() / gmax) for k, (a, b) in {
            "port-float64": (port, exact), "jax-float64": (jx, exact),
            "jax-golden": (jx, rg["golden"][name])}.items()})
        np.testing.assert_allclose(port, exact, rtol=0,
                                   atol=port_lim * gmax, err_msg=name)
        np.testing.assert_allclose(jx, rg["golden"][name], rtol=0,
                                   atol=jax_lim * gmax, err_msg=name)


def test_resnet_golden_weighted_subtree_top8(resnet_golden):
    """weighted_subtree_ebp_top8 of demo/whitebox_goldens.npz from the
    port's per-probe path: ebp_version 5 (the uint8 map), the traced
    injection over the 16 top-ranked candidates, subtree mode "all",
    top-8, the triplet classifier of the JAX net's encodings, float32 at
    full depth.  Held at test_demo_goldens.py's tolerance."""
    rg = resnet_golden
    wb = _golden_whitebox(rg, np.float32)
    wb5 = Whitebox(wb.net, ebp_version=5, ebp_subtree_mode=rg["mode"])
    wb5.net.set_triplet_classifier(rg["em"], rg["en"])
    smap, _, _, k = wb5.weighted_subtree_ebp(
        rg["x"], 0, 1, topk=8, subtree_mode="all", max_candidates=16,
        return_subtree_maps=False)
    g = rg["golden"]["weighted_subtree_ebp_top8"]
    assert smap.dtype == np.uint8 and len(k) == 8
    np.testing.assert_allclose(smap.astype(np.float32), g, rtol=1e-3,
                               atol=1e-5 * max(g.max(), 1e-12))
