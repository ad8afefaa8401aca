"""STRise over the VGGFace2 SENet-50-256 matcher on the port's normal
path, on the CPU at one block a stage (full widths; the 7x7 average pool
needs the 224x224 input), on seeded random weights made as the benchmark
makes them (``xfr_bench.harness.make_weights``, then the excitation
scaled by ``calibrate_gates`` so the gates spread over (0, 1)):

- the program's encode against ``xfr_bench/reference/senet50_256.py`` in
  float64 and in float32, and the reference with its gates flattened
  (``flat_gates``) outside the same tolerance;
- ``STRise(black_box="senet50_256")``'s map, mask scores and prior (the
  mean-EBP prior on a ResNet-101 ``resnetv4_pytorch`` proxy) against
  ``xfr_bench/reference/strise_matcher.py``, and the flattened-gate
  reference outside the same limits;
- K1's plain version with the VGGFace2 mean against the materialized
  blend;
- ``generate_bb_saliency --net senet50_256``: the chunk scorer, with the
  resnetv4 prior net built beside the matcher;
- the counters ``xfr.enc.se_gates`` and ``xfr.bb.rows_scored``.
"""

import glob
import os
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tests.fixtures import make_mini_dataset

from xfr_bench import harness as H
from xfr_bench.kinds.strise import compare
from xfr_bench.reference import senet50_256 as RSE
from xfr_bench.reference import strise_matcher as RM
from xfr_torch.blackbox import strise as S
from xfr_torch.blackbox.fused_blend import fused_mask_blend_preprocess
from xfr_torch.blackbox.masks import upsample_shift_masks_static
from xfr_torch.models import resnet101 as R101
from xfr_torch.models import vggface2 as VF2
from xfr_torch.utils import profiling

SEED = 2 ** 35 + 19
SPEC = {"num_masks": 32, "mask_scale": 28, "mask_elements": 2,
        "blur_fill_pct": 4}
CHUNK = 16
# The program against the reference, both float32 on the CPU, 32 masks:
# map 1.1e-3, mask scores 9.1e-5, prior 5.6e-8 (seed 2**40 + 17); the
# flattened gates read map 0.59 and mask scores 1.14.
LIMITS = {"map_gap": 0.02, "cts_gap": 0.005, "prior_gap": 1e-6}


def _images(n, tag):
    g = torch.Generator().manual_seed(H.derive(SEED, tag))
    return torch.randint(0, 256, (n, 224, 224, 3), generator=g,
                         dtype=torch.uint8)


@pytest.fixture(scope="module")
def nets():
    """The SENet matcher and its ResNet-101 proxy at one block a stage:
    configurations, weights (the same tensors for program and reference)
    and the program's Whiteboxes."""
    torch.set_num_threads(max(1, min(4, torch.get_num_threads())))
    cfg = H.config("senet50_256")
    cfg["layers"] = [1, 1, 1, 1]
    params = H.make_weights(RSE.param_shapes(cfg), SEED, "cpu")
    RSE.calibrate_gates(params, cfg, _images(2, "gates"),
                        cfg["se_logit_std"])
    pcfg = H.config("resnet101_l2")
    pcfg.update(layers=[1, 1, 1, 1], num_classes=101,
                program_name="resnetv4_pytorch")
    pparams = H.make_weights(pcfg["reference"].param_shapes(pcfg),
                             H.derive(SEED, "proxy"), "cpu")
    wb = cfg["program"].program(cfg, params, "cpu")
    proxy = pcfg["program"].program(pcfg, pparams, "cpu")
    # the embeddings' batch: the probe's, refs' and gallery's encodes pad
    # to it (32 by default)
    wb.batch_size = proxy.batch_size = 4
    return types.SimpleNamespace(cfg=cfg, params=params, pcfg=pcfg,
                                 pparams=pparams, wb=wb, proxy=proxy)


def _scene(seed=1):
    """(probe, refs, gallery): the probe drawn from ``seed``; the
    references (a noisy copy of seed 1's probe) and the gallery fixed."""
    def probe_of(seed):
        p = np.random.RandomState(seed).randint(
            0, 256, (224, 224, 3)).astype(np.uint8)
        p[40:100, 60:140] = 220
        return p

    rng = np.random.RandomState(0)
    ref = probe_of(1).astype(int) + rng.randint(-20, 20, (224, 224, 3))
    refs = [np.clip(ref, 0, 255).astype(np.uint8)]
    gal = [rng.randint(0, 256, (224, 224, 3)).astype(np.uint8)
           for _ in range(2)]
    return probe_of(seed), refs, gal


def _strise(nets, black_box="senet50_256", seed=1, **kw):
    probe, refs, gal = _scene(seed)
    return S.STRise(
        probe=probe, refs=refs, gallery=gal, black_box=black_box,
        net_dict={("senet50_256", 6): nets.wb,
                  ("resnetv4_pytorch", 6): nets.proxy,
                  ("resnetv4_pytorch", None): nets.proxy},
        prior_type="mean_ebp", num_masks=SPEC["num_masks"],
        mask_scale=SPEC["mask_scale"],
        num_mask_elements=SPEC["mask_elements"], mask_fill_type="blur",
        blur_fill_sigma_percent=SPEC["blur_fill_pct"], seed=7,
        batch_size=CHUNK, score_precision="high", device="cpu", **kw)


def _reference(nets, flat_gates=False, seed=1):
    probe, refs, gal = _scene(seed)
    r = RM.saliency_map(nets.params, nets.cfg, nets.pparams, nets.pcfg,
                        torch.from_numpy(probe),
                        torch.from_numpy(np.stack(refs)),
                        torch.from_numpy(np.stack(gal)), 7, SPEC,
                        block=CHUNK, flat_gates=flat_gates)
    return {0: {k: v.numpy().astype(np.float64) for k, v in r.items()}}


def test_full_depth_graph_has_16_gates_and_resnet_none():
    assert VF2.build_senet50_256()[0].n_gates == 16
    assert VF2.build_resnet50_128()[0].n_gates == 0
    assert R101.build_resnet101(num_classes=10)[0].n_gates == 0


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-11),
                                       (torch.float32, 2e-5)])
def test_encode_matches_reference_and_not_flat_gates(nets, dtype, tol):
    """The program's encode against the reference's, relative to the
    embedding's largest magnitude: float64 at rounding, float32 within
    the spread of two op orders (the program's BatchNorm is
    (x - mean) / sqrt(var + eps) * gamma + beta, the reference's
    F.batch_norm).  The gates matter: flattened, the reference lands far
    outside the same tolerance."""
    params = {n: {k: v.to(dtype) for k, v in p.items()}
              for n, p in nets.params.items()}
    wb = nets.cfg["program"].program(nets.cfg, params, "cpu")
    x = RSE.preprocess(_images(3, "encode").to(dtype))
    with torch.no_grad():
        got = wb.net.encode(x).reshape(3, -1)
        want = RSE.encode(params, nets.cfg, x)
        flat = RSE.encode(params, nets.cfg, x, flat_gates=True)
    scale = want.abs().max()
    assert float((got - want).abs().max() / scale) < tol
    assert float((flat - want).abs().max() / scale) > 100 * tol


def test_calibrated_gates_spread_over_the_unit_interval(nets):
    """At the configuration's logit spread (1.5) the gates of every block
    span most of (0, 1), where the plain random init drives their logits
    to a spread of tens, the gates to 0 or 1: a hard channel mask."""
    spread = RSE.gate_spread(nets.params, nets.cfg, _images(2, "probes"))
    assert len(spread) == 4
    for std, lo, hi in spread.values():
        assert 0.7 < std < 3.0 and lo < 0.2 and hi > 0.8
    plain = H.make_weights(RSE.param_shapes(nets.cfg), SEED, "cpu")
    for std, lo, hi in RSE.gate_spread(plain, nets.cfg,
                                       _images(2, "probes")).values():
        assert std > 10 and lo < 1e-6 and hi > 1 - 1e-6


@pytest.mark.parametrize("flat_gates", [False, True])
def test_strise_senet_matches_reference(nets, flat_gates):
    """STRise over SENet through the chunk scorer (the materialized-mask
    path, float32) against the plain reference: within LIMITS; the
    reference with flattened gates fails them."""
    st = _strise(nets)
    smap = st.launch_evaluate()()
    got = {0: {"map": np.asarray(smap, np.float64),
               "cts": np.asarray(st.mask_scores, np.float64),
               "prior": st.prior.double().numpy()}}
    numbers = compare(got, _reference(nets, flat_gates=flat_gates))
    ok = all(numbers[k] <= v for k, v in LIMITS.items())
    assert ok != flat_gates, numbers


def test_k1_plain_with_the_vggface2_mean_equals_the_materialized_blend(
        nets):
    """K1's plain version, handed the VGGFace2 mean, against the
    materialized masks blended and preprocessed as VGGFace2; and STRise
    over SENet with K1 on (its plain version on the CPU) against K1
    off."""
    g = torch.Generator().manual_seed(3)
    grids = (torch.rand((5, 19, 19), generator=g) > 0.2).float()
    shifts = torch.randint(0, 12, (5, 2), generator=g, dtype=torch.int32)
    probe = torch.rand((224, 224, 3), generator=g) * 255
    fill = torch.rand((224, 224, 3), generator=g) * 255
    got = fused_mask_blend_preprocess(
        grids, shifts, probe, fill,
        VF2.mean_vggface2(torch.float32, torch.device("cpu")), mask_scale=12)
    m = upsample_shift_masks_static(grids, shifts, (224, 224), 12)[..., None]
    want = VF2.preprocess_vggface2_batch(m * probe + (1.0 - m) * fill)
    np.testing.assert_array_equal(got.numpy(), want.numpy())

    on, off = _strise(nets, use_pallas_blend=True), _strise(nets)
    map_on, map_off = on.launch_evaluate()(), off.launch_evaluate()()
    np.testing.assert_allclose(on.mask_scores, off.mask_scores, rtol=1e-5,
                               atol=1e-6)
    # K1 on drains through the host combine, K1 off through the fused
    # select+combine: float32 sums in two orders, 1.2e-4 apart here
    np.testing.assert_allclose(map_on, map_off, atol=1e-3)


def test_bb_cli_scores_senet_on_the_chunk_scorer(tmp_path, monkeypatch,
                                                  nets):
    """``generate_bb_saliency --net senet50_256`` (the factory patched to
    the small nets): STRise's chunk scorer encodes the masked probes on
    SENet's graph, the host embeddings path is never taken, and the prior
    net, ("resnetv4_pytorch", None), is built beside the matcher."""
    import xfr_torch.models
    from xfr_torch.cli import generate_bb_saliency as T

    built, graphs = [], []
    by_name = {"senet50_256": nets.wb, "resnetv4_pytorch": nets.proxy}

    def create(name, **kw):
        built.append((name, kw.get("ebp_version")))
        return by_name[name]

    def refuse(wb):
        raise AssertionError("the host embeddings path was taken")

    real = S._encode_and_score

    def scored(graph, *a):
        graphs.append(graph)
        return real(graph, *a)

    monkeypatch.setattr(xfr_torch.models, "create_wbnet", create)
    monkeypatch.setattr(T, "make_bb_score_fn", refuse)
    monkeypatch.setattr(S, "_encode_and_score", scored)
    data_dir = str(tmp_path / "data")
    os.makedirs(data_dir)
    make_mini_dataset(data_dir, net_name="senet50_256", mask_ids=(2,))
    out = str(tmp_path / "smaps")
    T.main(["--net", "senet50_256", "--data-dir", data_dir,
            "--saliency-dir", out, "--mask", "2", "--num-masks", "32"])
    assert "senet50_256" in T.BUILTIN
    assert built == [("senet50_256", 6), ("resnetv4_pytorch", None)]
    assert graphs and all(g is nets.wb.net.graph for g in graphs)
    files = glob.glob(os.path.join(
        out, "senet50_256/subject_ID_1/img/p1/inpainted", "*.npz"))
    assert len(files) == 1
    assert np.isfinite(np.load(files[0])["saliency_map"]).all()


def _counted(fn):
    before = profiling.counters()
    with profile(activities=[ProfilerActivity.CPU]):
        fn()
    return {k: v - before.get(k, 0) for k, v in profiling.counters().items()
            if v != before.get(k, 0)}


def test_gates_and_scored_rows_are_counted(nets):
    """Under a profiler a STRise map over SENet counts a gate a row a
    gated block: with the probe's embedding in the memo, exactly the
    scored rows' (32 masks in chunks of 16), else also the probe encode's
    padded batch; a ResNet map scores rows and counts no gate; with no
    profiler nothing is counted.  Each encode counts its BatchNorm rows,
    all in a fused epilogue, and the prior's one-row walk on the proxy
    its own, unfused."""
    n_gates, bs = nets.wb.net.graph.n_gates, nets.wb.batch_size
    n_bn, p_bn = nets.wb.net.graph.n_bn, nets.proxy.net.graph.n_bn
    assert (n_gates, n_bn, p_bn) == (4, 17, 13)

    def bn(rows, n=n_bn):
        return {"xfr.enc.bn_rows": n * rows + p_bn,
                "xfr.enc.bn_rows_fused": n * rows}

    # a finished map puts the probe's embedding in the memo; the counts
    # are the launch's
    _strise(nets).launch_evaluate()()
    warm = _counted(lambda: _strise(nets).launch_evaluate())
    assert warm == {"xfr.bb.rows_scored": 32,
                    "xfr.enc.se_gates": n_gates * 32, **bn(32)}
    cold = _counted(lambda: _strise(nets, seed=3).launch_evaluate())
    assert cold == {"xfr.bb.rows_scored": 32,
                    "xfr.enc.se_gates": n_gates * (32 + bs),
                    **bn(32 + bs)}
    # the proxy as the black box also encodes the probe, the ref and the
    # gallery, a padded batch each
    resnet = _counted(lambda: _strise(
        nets, black_box="resnetv4_pytorch").launch_evaluate())
    assert resnet == {"xfr.bb.rows_scored": 32, **bn(32 + 3 * bs, p_bn)}
    before = profiling.counters()
    _strise(nets, seed=5).launch_evaluate()
    assert profiling.counters() == before
