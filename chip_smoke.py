#!/usr/bin/env python3
"""Drive the xfr_torch port's main path on one CUDA card and check it.

    python3 chip_smoke.py

Phases, one JSON line each; a failing phase raises, the script exits
non-zero and prints no result line.  Each phase is a function of this
module, so a subset runs as ``python3 -c "import chip_smoke as c;
c.phase_device(); c.phase_build(); c.phase_lightcnn()"``:

  device     the card (torch) and its name and power limit (nvidia-smi)
  build      every CUDA kernel of the path, compiled from xfr_torch/csrc
  kernel     each kernel against its plain PyTorch version at the main
             path's shapes (N=64 masks, 19x19 grids, 224x224, scale 12):
             error, times (CUDA events, median), bound
  precision  precision_scope: full float32 under "high", TF32 under None
  prior      the mean-EBP prior on the card vs the plain path on the CPU
             (ResNet-101 at full widths, 65,359 classes, layers (1,1,1,1))
  main       STRise on full ResNet-101+L2 with random weights: 6,500
             masks, mean-EBP prior, blur fill 4%, scale 12, 2 elements,
             the fused-blend kernel, score_precision "high"; one warm-up
             map, then 3 timed maps; the kernel must launch 102 times a map
  branches   the same seed and prior on the materialized-mask branch:
             the same masks, agreeing scores and maps
  tf32       the same maps with score_precision=None (TF32 allowed)
  breakdown  where one map's time goes
  wb_parity  bench.py's whitebox 4-map mix (mean-EBP, contrastive,
             truncated-contrastive, weighted-subtree top-32) on the card
             and on the CPU, same weights: ResNet-101 at full widths with
             one block per stage, B=2, float32 sweep
  whitebox   the same mix on full ResNet-101+L2, B=8, bfloat16 sweep: one
             warm-up mix with every host sync refused during the launches,
             then 5 timed mixes launched and drained as bench.py does;
             maps/s, peak memory, each stage's CUDA-event time, the host
             drain, launch against mix time, and the sweep's launches per
             probe (one torch.profiler pass) and peak memory
  wsebp_bf16 one full-depth probe's weighted-subtree map, bfloat16 sweep
             against float32 sweep
  eval_parity the inpainting game's evaluation core (TwinClsBatch: the
             blend+encode of every threshold mask, twin classification) on
             the card and on the CPU, same weights: ResNet-101 at full
             widths with one block per stage, one probe/twin pair,
             bench.py's four maps, T cut to 21 percentiles; on the card the
             multi-map, single-map and host-blend paths must agree
  eval       bench.py's eval workload (bench.py:117-194) on full
             ResNet-101+L2: 2 probe/twin pairs, 4 maps, 101 percentiles;
             one warm-up group with every host sync refused during its
             launches and flush, then 10 timed groups with one in flight;
             evals/s, peak memory, launch against group time, host IoU
             time, steps and rows per group, and one profiled group's
             device time by kernel group, the blend's share and idle share
  wsebp_parity the per-probe weighted_subtree_ebp (fused, host and
             max_candidates paths) on the card and on the CPU, same
             weights: ResNet-101 at full widths with one block per stage,
             float32 sweep, top-32, norelu; on the card the per-probe map
             must equal the batched path's
  generate   the generation stage on full ResNet-101+L2
             ("resnetv4_pytorch", the CLIs' default net) with the CLIs'
             defaults and in-memory jobs: the batched whitebox generator's
             groups (19 jobs: 8, 8 and a padded 3), double-buffered as
             generate_wb_smaps_batched runs them, after one warm-up group
             launched with every host sync refused; one probe through the
             serial method functions; two STRise jobs (6,500 masks,
             mean-EBP prior, "high") through one BBPipeline, each map
             against STRise.evaluate() of the same seed.  Maps/s, peak
             memory, per-method times; the writer normalizes each map as
             create_save_smap does and saves its npz (no PNG: the card's
             machine has no imageio)
  models_parity  the other matchers on the card and on the CPU, same
             weights: LightCNN-29 v2 (full widths, 80,013 classes, one
             block a stage) and ResNet-50-128 in float32, SENet-50-256 and
             VGG-16 in float64 and in float32 (ill-conditioned in float32
             at random weights: the card's float32 against the float64
             CPU within 3 times the CPU's own float32 error); forward, ebp
             and the contrastive pair, and LightCNN's weighted-subtree
             top-32 in affineonly_with_prior; SENet's EBP must raise on
             its Sigmoid
  lightcnn   the slice's full-width path: create_wbnet("lightcnn") (88
             events, 80,013 classes) runs the 4-map mix on B=8 random
             128x128 probes in affineonly_with_prior, bfloat16 sweep, as
             whitebox runs it (host syncs refused during one mix's
             launches); then one eval group on a 1x128x128 pair
  vggface2   the same mix on full ResNet-50-128 (the interleaved [2B, 128]
             classifier in place of its fc1), norelu
  variants   layerwise_ebp, the 8 layerwise_contrastive_ebp modes and
             subtree_ebp on full ResNet-101, timed; the same plus the
             serial percentile mode card against CPU at one block a
             stage, in float64 and in float32; STRise's uint8 prior card
             against CPU
  eccv20     python -m xfr_torch.cli.eccv20 --figure 3 --subjects 2 on a
             synthetic JPEG corpus, full LightCNN-29 v2 on the card

The last lines are the card's name and power limit, the "kernels" line
and {"ok": true, "device": {...}}.
"""

import contextlib
import gc
import json
import subprocess
import sys
import time
import warnings

import numpy as np

# NVIDIA H100 SXM data sheet: HBM rate and float32 rate outside the
# tensor cores (the kernels here do plain float32 arithmetic)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12

N_MASKS, CHUNK, SCALE, ELEMS, SIZE = 6500, 64, 12, 2, 224
WB_B, WB_TOPK, WB_TIMED = 8, 32, 5  # bench.py's whitebox mix
# bench.py's eval: 4 maps a probe group, 10 timed groups, 101 percentiles
EVAL_MAPS, EVAL_GROUPS = 4, 10
EVAL_PCT = np.unique(np.sort(np.append(np.arange(0, 100, 1), [0, 100])))


def emit(phase, **rec):
    print(json.dumps({"phase": phase, **rec}), flush=True)


def cuda_ms(fn, reps=15, inner=10, warmup=3, hold_cycles=20_000_000):
    """Median over ``reps`` of the mean device time of ``inner``
    back-to-back calls, by CUDA events.  A spin of ``hold_cycles`` clock
    cycles (10 ms at 1.98 GHz) is queued ahead of the start event, so the
    host has enqueued every call before the device reaches them: the
    time is the device's, not the host's launch rate."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(hold_cycles)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return float(np.median(times))


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    emit("device", kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda)
    return smi


def phase_build():
    from xfr_torch import kernels

    t0 = time.time()
    kernels.load("fused_blend")
    emit("build", seconds=time.time() - t0,
         libraries=[kernels.library_path("fused_blend")])


def fused_blend_inputs(seed=0):
    """Main-path-shaped inputs: a chunk of 64 sparse 19x19 grids with 2
    zeros each, shifts in [0, 12), a 0..255 probe and its blur fill."""
    import torch
    from xfr_torch.blackbox import masks as M
    from xfr_torch.models.resnet101 import MEAN_RGB

    g = torch.Generator(device="cuda").manual_seed(seed)
    gh = -(-SIZE // SCALE)
    probs = torch.full((gh, gh), 1.0 / (gh * gh), device="cuda")
    grids = M.sample_sparse_grids(g, probs, CHUNK, ELEMS)
    shifts = M.random_shifts(g, CHUNK, SCALE, "cuda")
    probe = torch.rand((SIZE, SIZE, 3), generator=g, device="cuda") * 255
    fill = M.gaussian_blur(probe, 0.04 * SIZE)
    mean = torch.as_tensor(MEAN_RGB, dtype=torch.float32, device="cuda")
    return grids, shifts, probe, fill, mean


def phase_kernel():
    import torch
    from xfr_torch.blackbox import fused_blend as FB

    args = fused_blend_inputs()
    out = FB.fused_mask_blend_preprocess(*args, mask_scale=SCALE)
    ref = FB.fused_mask_blend_preprocess_reference(*args, mask_scale=SCALE)
    torch.cuda.synchronize()
    err = (out - ref).abs()
    max_abs = float(err.max())
    max_rel = float((err / ref.abs().clamp(min=1e-6)).max())
    ok = bool(torch.allclose(out, ref, rtol=1e-4, atol=1e-3))
    ms = cuda_ms(lambda: FB.fused_mask_blend_preprocess(
        *args, mask_scale=SCALE))
    plain_ms = cuda_ms(lambda: FB.fused_mask_blend_preprocess_reference(
        *args, mask_scale=SCALE))
    grids, shifts, probe, fill, mean = args
    n, gh, gw = grids.shape
    # each input read once, the output written once
    nbytes = 4 * (grids.numel() + shifts.numel() + probe.numel()
                  + fill.numel() + mean.numel() + out.numel())
    # per pixel: 2 source coordinates (3 each), the 2x2 tap weights and
    # sum (9), 1 - m (1), and per channel 2 mul, 1 add, 1 sub (12)
    ops = n * SIZE * SIZE * 28
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS_PER_S
    rec = {"name": "fused_mask_blend_preprocess", "route": "cuda",
           "source": "xfr_torch/csrc/fused_blend.cu",
           "replaces": "xfr_tpu/blackbox/pallas_blend.py:66",
           "launches": None, "max_abs_err": max_abs, "ms": ms,
           "plain_ms": plain_ms, "bound_ms": 1e3 * max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "library_ms": None}
    emit("kernel", max_rel_err=max_rel, rtol=1e-4, atol=1e-3, ok=ok,
         bytes=nbytes, ops=ops, shapes={"grids": [n, gh, gw],
                                        "out": list(out.shape)}, **rec)
    if not ok:
        raise AssertionError("fused_blend kernel disagrees with its plain "
                             f"version: max abs err {max_abs}")
    return rec


def phase_precision():
    import torch
    import torch.nn.functional as F
    from xfr_torch.utils.device import precision_scope

    g = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn((8, 64, 56, 56), generator=g, device="cuda")
    w = torch.randn((64, 64, 3, 3), generator=g, device="cuda")
    a = torch.randn((1024, 1024), generator=g, device="cuda")
    y64 = F.conv2d(x.double(), w.double(), padding=1)
    m64 = a.double() @ a.double()
    before = (torch.backends.cudnn.allow_tf32,
              torch.backends.cuda.matmul.allow_tf32)
    rec = {}
    for p in (None, "high"):
        with precision_scope(p):
            y = F.conv2d(x, w, padding=1)
            m = a @ a
        rec[str(p)] = {
            "conv_rel_err": float((y.double() - y64).abs().max()
                                  / y64.abs().max()),
            "matmul_rel_err": float((m.double() - m64).abs().max()
                                    / m64.abs().max())}
    after = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    emit("precision", errors=rec, flags_restored=before == after)
    if before != after or max(rec["high"].values()) > 1e-5:
        raise AssertionError(f"precision_scope: {rec}, {before}->{after}")


def _images(seed, n):
    rng = np.random.RandomState(seed)
    return [(rng.rand(SIZE, SIZE, 3) * 255).astype(np.uint8)
            for _ in range(n)]


def main_path_net():
    """Full-depth ResNet-101+L2 with random numpy-init weights on the card,
    serving as matcher and mean-EBP prior net, as bench.py aliases it.
    Returns (Whitebox, net_dict)."""
    from xfr_torch.models import create_wbnet

    wb = create_wbnet("resnetv6_pytorch", ebp_version=6, device="cuda")
    return wb, {("resnetv6_pytorch", 6): wb, ("resnetv4_pytorch", None): wb}


def make_main_path_strise(net_dict, seed, **kw):
    """The main path's STRise map for ``seed`` (bench.py's settings: 6,500
    masks, scale 12, 2 elements, blur fill 4%, mean-EBP prior), on one of
    four random probes with fixed refs and gallery.  ``kw`` adds the
    scorer's options (use_pallas_blend, score_precision)."""
    from xfr_torch.blackbox.strise import STRise

    probes = _images(0, 6)
    return STRise(probe=probes[seed % 4], refs=probes[4:5] + _images(2, 1),
                  gallery=_images(3, 2), black_box="resnetv6_pytorch",
                  net_dict=net_dict, mask_scale=SCALE,
                  num_mask_elements=ELEMS, mask_fill_type="blur",
                  blur_fill_sigma_percent=4, num_masks=N_MASKS, seed=seed,
                  prior_type="mean_ebp", device="cuda", **kw)


def phase_prior():
    """One probe's mean-EBP prior on the card and on the CPU, same weights:
    ResNet-101 at full widths and 65,359 classes, depth cut to one block
    per stage so the CPU side stays short."""
    from xfr_torch.blackbox.strise import STRise
    from xfr_torch.ebp.engine import Whitebox, WhiteboxNetwork
    from xfr_torch.models import common
    from xfr_torch.models import resnet101 as R101

    graph, shapes, enc = R101.build_resnet101(layers=(1, 1, 1, 1))
    params = common.init_params(shapes, seed=1)
    probe, ref, gal = _images(1, 3)
    priors = {}
    for dev in ("cuda", "cpu"):
        net = WhiteboxNetwork(graph, common.params_to(params, dev),
                              encode_tensor=enc, classifier_pname="fc2",
                              num_classes=65359)
        wb = Whitebox(net, ebp_version=6, ebp_subtree_mode="norelu")
        st = STRise(probe=probe, refs=[ref], gallery=[gal],
                    black_box="resnetv6_pytorch", device=dev,
                    net_dict={("resnetv4_pytorch", None): wb})
        t0 = time.time()
        st.mean_ebp_prior()
        priors[dev] = st.prior.cpu().numpy()
        priors[dev + "_s"] = time.time() - t0
    gpu, cpu = priors["cuda"], priors["cpu"]
    err = float(np.abs(gpu - cpu).max() / np.abs(cpu).max())
    emit("prior", max_err_rel_to_max=err, tol=1e-3, shape=list(gpu.shape),
         cuda_s=priors["cuda_s"], cpu_s=priors["cpu_s"])
    if not (np.isfinite(gpu).all() and err < 1e-3):
        raise AssertionError(f"mean-EBP prior: card vs CPU error {err}")


def check_map(smap):
    assert smap.shape == (SIZE, SIZE), smap.shape
    assert np.isfinite(smap).all()
    assert smap.min() >= 0.0 and smap.max() <= 1.0, (smap.min(), smap.max())


def main_path():
    import functools

    import torch
    from xfr_torch.blackbox import fused_blend as FB

    t0 = time.time()
    wb, net_dict = main_path_net()
    emit("net", seconds=time.time() - t0, nodes=len(wb.net.graph.nodes),
         events=wb.net.graph.n_events)
    make = functools.partial(make_main_path_strise, net_dict)

    fused = dict(use_pallas_blend=True, score_precision="high")
    check_map(make(0, **fused).launch_evaluate()())  # warm-up
    torch.cuda.synchronize()
    per_map = -(-N_MASKS // CHUNK)

    # --- the main path: counts at 0, three maps, counts read after ---
    torch.cuda.reset_peak_memory_stats()
    FB.fused_mask_blend_preprocess.launches = 0
    times, deltas, kept = [], [], None
    for seed in (1, 2, 3):
        c0 = FB.fused_mask_blend_preprocess.launches
        t0 = time.time()
        st = make(seed, **fused)
        smap = st.launch_evaluate()()
        torch.cuda.synchronize()
        times.append(time.time() - t0)
        deltas.append(FB.fused_mask_blend_preprocess.launches - c0)
        check_map(smap)
        if kept is None:
            kept = st
    launches = FB.fused_mask_blend_preprocess.launches
    peak = torch.cuda.max_memory_allocated()
    emit("main", maps=3, map_s=times, maps_per_s=3 / sum(times),
         launches=launches, launches_per_map=deltas, expected=per_map,
         peak_mem_bytes=peak, score_precision="high")
    if deltas != [per_map] * 3:
        raise AssertionError(f"fused_blend launched {deltas} times per "
                             f"map, expected {per_map}")
    return wb, make, kept, launches


def phase_branches(make, st_k):
    """The materialized-mask branch on the same seed and prior as the
    first timed map, through the same finishing code (score drain, then
    compute_saliency_map): the same masks, and the same scores and map
    up to float32 rounding.

    Tolerances.  The kernel's blends agree with the plain blend to one
    float32 step on 0..255, so after ResNet-101 in full float32 the
    similarity scores (differences of values near 1.0, where one float32
    step is 6e-8) agree to a few steps: score_atol 1e-6.  The map is
    1 - (a score-weighted mask mean of order 1e-4), normalized by its
    range, so one float32 step near 1.0 is ``q`` of the normalized map;
    the maps must agree to 4 such steps plus 1e-3."""
    import torch

    st_m = make(1, use_pallas_blend=False, score_precision="high")
    st_m.prior = st_k.prior.clone()
    st_m.generate_masks()
    st_m.apply_masks()
    st_m.score_masks()
    st_m.compute_saliency_map()
    same_masks = bool(torch.equal(st_m._masks_dev, st_k._masks_dev))
    ds = np.abs(st_m.mask_scores - st_k.mask_scores)
    sel_k, sel_m = st_k.mask_scores > 0, st_m.mask_scores > 0
    raw = st_k.combine_masks(sel_k)
    q = float(np.spacing(np.float32(0.5)) / (raw.max() - raw.min()))
    map_atol = 1e-3 + 4 * q
    dmap = float(np.abs(st_m.saliency_map - st_k.saliency_map).max())
    corr = float(np.corrcoef(st_m.saliency_map.ravel(),
                             st_k.saliency_map.ravel())[0, 1])
    emit("branches", same_masks=same_masks, score_max_abs_diff=float(ds.max()),
         score_abs_max=float(np.abs(st_k.mask_scores).max()),
         score_abs_median=float(np.median(np.abs(st_k.mask_scores))),
         selected=int(sel_k.sum()), selection_disagree=int((sel_k != sel_m)
                                                           .sum()),
         map_max_abs_diff=dmap, map_corr=corr, map_f32_step=q,
         tol={"score_atol": 1e-6, "map_atol": map_atol})
    check_map(st_m.saliency_map)
    if not same_masks or ds.max() > 1e-6 or dmap > map_atol:
        raise AssertionError("kernel and materialized branches disagree")


def phase_tf32(make, st_high):
    """The same maps with TF32 allowed in the scoring encode; the first
    (seed 1) is compared with the full-float32 map of the same seed."""
    import torch

    kw = dict(use_pallas_blend=True, score_precision=None)
    check_map(make(4, **kw).launch_evaluate()())  # warm-up
    times, first = [], None
    for seed in (1, 2, 3):
        t0 = time.time()
        st = make(seed, **kw)
        check_map(st.launch_evaluate()())
        torch.cuda.synchronize()
        times.append(time.time() - t0)
        first = first or st
    sel_h, sel_t = st_high.mask_scores > 0, first.mask_scores > 0
    emit("tf32", map_s=times, maps_per_s=3 / sum(times),
         score_precision=None,
         vs_high={"map_corr": float(np.corrcoef(
             first.saliency_map.ravel(), st_high.saliency_map.ravel())[0, 1]),
             "score_max_abs_diff": float(np.abs(
                 first.mask_scores - st_high.mask_scores).max()),
             "selection_disagree": int((sel_h != sel_t).sum()),
             "selected_high": int(sel_h.sum())})


def phase_breakdown(wb, make, kernel_ms):
    """One map step by step, each step ended by a synchronize, plus one
    scoring chunk's encode by CUDA events."""
    import torch
    from xfr_torch.blackbox.strise import _encode_and_score
    from xfr_torch.utils.device import precision_scope

    st = make(5, use_pallas_blend=True, score_precision="high")
    steps = {}

    def step(name, fn):
        t0 = time.time()
        out = fn()
        torch.cuda.synchronize()
        steps[name] = time.time() - t0
        return out

    step("prior", st.priors[st.prior_type])
    step("masks", st.generate_masks)
    step("fill", st.apply_masks)
    drain = step("score_enqueue", st._score_masks_launch)
    step("score_drain", drain)
    step("saliency", st.compute_saliency_map)
    check_map(st.saliency_map)

    x = torch.randn((CHUNK, 3, SIZE, SIZE), device="cuda")
    e = torch.randn((2, 512), device="cuda")
    net = wb.net
    with precision_scope("high"):
        enc_ms = cuda_ms(lambda: _encode_and_score(
            net.graph, net.encode_tensor, net.params, x, e, e),
            reps=5, inner=2, warmup=1)
    per_map = -(-N_MASKS // CHUNK)
    emit("breakdown", steps_s=steps, map_s=sum(steps.values()),
         encode_chunk_ms=enc_ms, encode_per_map_s=enc_ms * per_map / 1e3,
         fused_blend_per_map_s=kernel_ms * per_map / 1e3)


# ---------------------------------------------------------------------------
# Whitebox 4-map mix (bench.py:197-263)
# ---------------------------------------------------------------------------


def whitebox_net(device, layers=None, seed=2, dtype=None):
    """The whitebox matcher: full-depth ResNet-101+L2 from the factory, or
    one with ``layers`` blocks per stage and the numpy init of ``seed``
    (cast to ``dtype`` if given)."""
    from xfr_torch.ebp.engine import Whitebox, WhiteboxNetwork
    from xfr_torch.models import common, create_wbnet
    from xfr_torch.models import resnet101 as R101

    if layers is None:
        return create_wbnet("resnetv6_pytorch", device=device)
    graph, shapes, enc = R101.build_resnet101(layers=layers)
    net = WhiteboxNetwork(
        graph, common.params_to(common.init_params(shapes, seed=seed), device,
                                dtype=dtype),
        encode_tensor=enc, classifier_pname="fc2", num_classes=65359)
    return Whitebox(net, ebp_version=6, ebp_subtree_mode="norelu")


def whitebox_workload(wb, B, seed=0):
    """bench.py's whitebox inputs on the net's device: two mate and two
    nonmate images (0..50) whose mean encodings, unit-normed, make the
    triplet classifiers, and B probes."""
    import torch

    rng = np.random.RandomState(seed)
    dev = wb.device

    def imgs(n):
        return torch.as_tensor(rng.rand(n, 3, SIZE, SIZE) * 50,
                               dtype=torch.float32, device=dev)

    mates, nonmates = imgs(2), imgs(2)
    em, en = (e / e.norm() for e in (wb.encode(mates).mean(0),
                                     wb.encode(nonmates).mean(0)))
    return {"probes": imgs(B), "em": em, "en": en}


@contextlib.contextmanager
def host_syncs_refused(on):
    """Every operation that would wait for the card raises inside."""
    import torch

    if not on:
        yield
        return
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


@contextlib.contextmanager
def subtree_mode(wb, mode):
    """The engine's subtree mode swapped for a block, as
    launch_weighted_subtree_ebp_batch swaps it for its launch."""
    prev, wb._ebp_subtree_mode = wb._ebp_subtree_mode, mode
    try:
        yield
    finally:
        wb._ebp_subtree_mode = prev


def k1_launches():
    """K1's launch count so far (every wrapper call that launched it)."""
    from xfr_torch.blackbox import fused_blend as FB

    return FB.fused_mask_blend_preprocess.launches


def check_no_k1(phase, k1):
    if k1 != 0:
        raise AssertionError(f"the {phase} path launched K1 {k1} times")


def launch_mix(wb, w, refuse_syncs=False, mode="norelu"):
    """Enqueue the 4-map mix as bench.py does: every method's device work
    before any host read; the classifier swaps between launches are safe
    because each launch takes the params it was given.  ``mode`` is the
    weighted subtree's (the net's default: norelu for the ResNets,
    affineonly_with_prior for LightCNN)."""
    import torch

    probes, em, en = w["probes"], w["em"], w["en"]
    B = probes.shape[0]
    wb.net.reset_classifier()
    Pn = torch.ones((B, wb.net.num_classes()), device=probes.device)
    with host_syncs_refused(refuse_syncs):
        pooled, _ = wb._ebp_pooled_fn()(wb.net.params, probes, Pn)
    wb.set_triplet_classifier_batch((em / 2500.0).expand(B, -1),
                                    (en / 2500.0).expand(B, -1))
    with host_syncs_refused(refuse_syncs):
        finish_ct = wb.launch_contrastive_ebp_batch_both(probes, 20)
    wb.set_triplet_classifier_batch(em.expand(B, -1), en.expand(B, -1))
    with host_syncs_refused(refuse_syncs):
        finish_ws = wb.launch_weighted_subtree_ebp_batch(
            probes, topk=WB_TOPK, subtree_mode=mode)
    return pooled, finish_ct, finish_ws


def drain_mix(wb, launched):
    """The host side of one mix: {method: [B maps]} plus the selected
    subtrees of each probe."""
    pooled, finish_ct, finish_ws = launched
    pooled = pooled.cpu().numpy()
    contr, trunc = finish_ct()
    ws = finish_ws()
    return {"mean_ebp": [wb._mwp_to_saliency(p) for p in pooled],
            "contrastive": contr, "truncated_contrastive": trunc,
            "weighted_subtree": [r[0] for r in ws],
            "subtrees": [r[3] for r in ws]}


def check_wb_maps(out, shape=(112, 112)):
    """Every {method: [maps]} entry: saliency maps of ``shape`` (the
    plane of the net's first conv), finite, non-negative, unit mass."""
    for name, maps in out.items():
        if name == "subtrees":
            continue
        for m in maps:
            assert m.shape == shape, (name, m.shape)
            assert np.isfinite(m).all() and m.min() >= 0, name
            assert abs(float(m.sum(dtype=np.float64)) - 1.0) <= 1e-5, \
                (name, float(m.sum(dtype=np.float64)))


def phase_wb_parity():
    """The mix on the card and on the CPU with the same weights and the
    same triplet classifiers (encoded on the CPU): ResNet-101 at full
    widths, one block per stage, B=2, float32 sweep."""
    import torch

    wbs = {dev: whitebox_net(dev, layers=(1, 1, 1, 1))
           for dev in ("cpu", "cuda")}
    w_cpu = whitebox_workload(wbs["cpu"], 2, seed=1)
    ws = {"cpu": w_cpu, "cuda": {k: v.cuda() for k, v in w_cpu.items()}}
    out, secs = {}, {}
    for dev in ("cuda", "cpu", "cuda"):  # the first card mix warms up
        t0 = time.time()
        out[dev] = drain_mix(wbs[dev], launch_mix(wbs[dev], ws[dev]))
        secs[dev] = time.time() - t0
    for o in out.values():
        check_wb_maps(o)
    rec, ok = {}, True
    for name in ("mean_ebp", "contrastive", "truncated_contrastive",
                 "weighted_subtree"):
        errs = [float(np.abs(a - b).max() / np.abs(b).max())
                for a, b in zip(out["cuda"][name], out["cpu"][name])]
        corrs = [float(np.corrcoef(a.ravel(), b.ravel())[0, 1])
                 for a, b in zip(out["cuda"][name], out["cpu"][name])]
        rec[name] = {"max_err_rel_to_max": errs, "corr": corrs}
        if "contrastive" in name:
            ok &= min(corrs) >= 0.999
        else:
            ok &= max(errs) <= 1e-3
    shared = [len(set(a) & set(b)) for a, b in
              zip(out["cuda"]["subtrees"], out["cpu"]["subtrees"])]
    n_sel = [len(b) for b in out["cpu"]["subtrees"]]
    ok &= all(s >= min(30, n - 2) for s, n in zip(shared, n_sel))
    # the ranking pass's argmax: ties to the first index on the card too
    z = torch.zeros((2, 50), device="cuda")
    z[1, [7, 19]] = 1.0
    ties = torch.argmax(z, dim=1).tolist()
    ok &= ties == [0, 7]
    emit("wb_parity", methods=rec, subtrees_shared=shared,
         subtrees_selected=n_sel, argmax_ties=ties,
         cuda_mix_s=secs["cuda"], cpu_mix_s=secs["cpu"],
         tol={"mean_ebp_and_weighted_subtree_max_err_rel_to_max": 1e-3,
              "contrastive_corr_min": 0.999,
              "subtrees_shared_min": "min(30, selected - 2)"})
    if not ok:
        raise AssertionError(f"whitebox mix: card and CPU disagree: {rec}, "
                             f"shared subtrees {shared}, ties {ties}")


def stage_event_ms(wb, w, mode="norelu"):
    """One mix stage by stage, CUDA events between the stages: stream
    time, which includes any wait for the host."""
    import torch

    probes, em, en = w["probes"], w["em"], w["en"]
    B = probes.shape[0]
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    torch.cuda.synchronize()
    wb.net.reset_classifier()
    Pn = torch.ones((B, wb.net.num_classes()), device="cuda")
    ev[0].record()
    wb._ebp_pooled_fn()(wb.net.params, probes, Pn)
    ev[1].record()
    wb.set_triplet_classifier_batch((em / 2500.0).expand(B, -1),
                                    (en / 2500.0).expand(B, -1))
    wb._contrastive_both_fn()(wb.net.params, probes,
                              wb._batch_cotangents(B, "contrastive"), 20.0)
    ev[2].record()
    wb.set_triplet_classifier_batch(em.expand(B, -1), en.expand(B, -1))
    with subtree_mode(wb, mode):
        scores, idxs, vals = wb._wsebp_grad_batch_fn()(wb.net.params, probes,
                                                       True)
        ev[3].record()
        wb._wsebp_sweep_select_scan_fn(WB_TOPK, False)(
            wb.net.params, probes, idxs.to(torch.int32), vals, scores)
        ev[4].record()
    torch.cuda.synchronize()
    names = ("mean_ebp", "contrastive_both", "ranking_pass",
             "sweep_select_merge")
    return {n: ev[i].elapsed_time(ev[i + 1]) for i, n in enumerate(names)}


def sweep_launches_per_probe(wb, w, mode="norelu"):
    """Kernels and ATen operator calls of one B-probe sweep+select+merge,
    from torch.profiler, per probe; and the sweep's peak memory (the net,
    the probes and the ranking pass's outputs included)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    probes, em, en = w["probes"], w["em"], w["en"]
    B = probes.shape[0]
    wb.set_triplet_classifier_batch(em.expand(B, -1), en.expand(B, -1))
    with subtree_mode(wb, mode):
        scores, idxs, vals = wb._wsebp_grad_batch_fn()(wb.net.params, probes,
                                                       True)
        sweep = wb._wsebp_sweep_select_scan_fn(WB_TOPK, False)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            sweep(wb.net.params, probes, idxs.to(torch.int32), vals, scores)
            torch.cuda.synchronize()
    kernels = aten = 0
    busy_us = 0.0
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            kernels += e.count
            busy_us += e.self_device_time_total
        elif e.key.startswith("aten::"):
            aten += e.count
    return {"kernels_per_probe": kernels / B, "aten_calls_per_probe":
            aten / B, "device_busy_ms": busy_us / 1e3,
            "peak_mem_bytes": torch.cuda.max_memory_allocated()}


def run_mix(wb, w, mode="norelu", shape=(112, 112), profile=True):
    """The mix as bench.py runs it: one warm-up mix with host syncs refused
    during the launches, then WB_TIMED mixes launched and drained
    double-buffered; then one mix alone, and (``profile``) its stages by
    CUDA events and the sweep's launches per probe.  Returns the record."""
    import torch

    B = w["probes"].shape[0]
    t0 = time.time()
    k1_0 = k1_launches()
    out = drain_mix(wb, launch_mix(wb, w, refuse_syncs=True, mode=mode))
    torch.cuda.synchronize()
    warm_s = time.time() - t0
    check_wb_maps(out, shape)

    # the peak is this mix's: nets of earlier phases held in reference
    # cycles are freed first
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    start_mem = torch.cuda.memory_allocated()
    times, launch_s, drain_s = [], [], []
    t0 = time.time()
    tl = time.time()
    prev = launch_mix(wb, w, mode=mode)
    launch_s.append(time.time() - tl)
    for _ in range(WB_TIMED - 1):
        tl = time.time()
        st = launch_mix(wb, w, mode=mode)
        launch_s.append(time.time() - tl)
        td = time.time()
        check_wb_maps(drain_mix(wb, prev), shape)
        drain_s.append(time.time() - td)
        t1 = time.time()
        times.append(t1 - t0)
        t0, prev = t1, st
    td = time.time()
    last = drain_mix(wb, prev)
    check_wb_maps(last, shape)
    drain_s.append(time.time() - td)
    times.append(time.time() - t0)
    peak = torch.cuda.max_memory_allocated()

    # one mix alone: the launch call against the whole mix
    torch.cuda.synchronize()
    t0 = time.time()
    st = launch_mix(wb, w, mode=mode)
    one_launch = time.time() - t0
    drain_mix(wb, st)
    one_mix = time.time() - t0

    rec = {}
    if profile:
        rec["stage_event_ms"] = stage_event_ms(wb, w, mode)
        rec["sweep"] = sweep_launches_per_probe(wb, w, mode)
    k1 = k1_launches() - k1_0
    wb.net.reset_classifier()
    # as in bench.py, interval i ends with mix i's drain while mix i+1 is
    # queued; the intervals add up to the WB_TIMED mixes
    rec.update(batch=B, maps_per_mix=4 * B, mixes=WB_TIMED,
               interval_s=times, maps_per_s=4 * B * WB_TIMED / sum(times),
               warmup_s=warm_s, peak_mem_bytes=peak,
               start_mem_bytes=start_mem, launch_s=launch_s,
               drain_s=drain_s, one_mix={"launch_s": one_launch,
                                         "mix_s": one_mix},
               subtree_mode=mode, subtrees_selected=[
                   len(k) for k in last["subtrees"]],
               wsebp_dtype=str(wb.wsebp_dtype).replace("torch.", ""),
               k1_launches=k1)
    check_no_k1("whitebox mix", k1)
    return rec


def phase_whitebox():
    """bench.py's whitebox mix on full ResNet-101+L2: B=8, bfloat16 sweep,
    one warm-up mix with host syncs refused during the launches, then
    WB_TIMED mixes launched and drained double-buffered."""
    import torch

    wb = whitebox_net("cuda")
    wb.wsebp_dtype = torch.bfloat16
    w = whitebox_workload(wb, WB_B)
    emit("whitebox", **run_mix(wb, w))
    return wb, w


def phase_wsebp_bf16(wb, w):
    """One full-depth probe's weighted-subtree top-32 map with the sweep in
    bfloat16 against float32: the ranking pass is float32 in both (equal
    scores), the selections overlap and the maps correlate > 0.98
    (tests/test_compute_dtype.py's gate, at full depth)."""
    import torch

    probe = w["probes"][:1]
    wb.set_triplet_classifier_batch(w["em"][None], w["en"][None])
    res = {}
    for name, dt in (("float32", torch.float32),
                     ("bfloat16", torch.bfloat16)):
        wb.wsebp_dtype = dt
        res[name] = wb.weighted_subtree_ebp_batch(
            probe, topk=WB_TOPK, subtree_mode="norelu")[0]
    wb.wsebp_dtype = torch.bfloat16
    wb.net.reset_classifier()
    (m32, _, sc32, k32), (m16, _, sc16, k16) = res["float32"], res["bfloat16"]
    corr = float(np.corrcoef(m32.ravel(), m16.ravel())[0, 1])
    shared = len(set(k32) & set(k16))
    scores_equal = bool(np.allclose(sc16, sc32, rtol=1e-6))
    need = -(-2 * len(k32) // 3)  # the gate's 2 of 3, scaled to topk
    emit("wsebp_bf16", corr=corr, subtrees_shared=shared,
         selected_f32=len(k32), selected_bf16=len(k16),
         ranking_scores_equal=scores_equal,
         tol={"corr_min": 0.98, "shared_min": need})
    if not (corr > 0.98 and shared >= need and scores_equal):
        raise AssertionError(f"bfloat16 sweep: corr {corr}, shared {shared}"
                             f" of {len(k32)}, scores equal {scores_equal}")


# ---------------------------------------------------------------------------
# Inpainting-game evaluation stage (bench.py:117-194)
# ---------------------------------------------------------------------------


def eval_workload(wb, seed=0, percentiles=EVAL_PCT, chw=(3, SIZE, SIZE)):
    """bench.py's eval inputs: 2 probe/twin pairs (probe 0..50, twin =
    probe + 0..30), galleries of 2 noisy copies each (unit-normed mean
    encodings from ``wb``), 4 saliency maps with the salient box
    [60:120, 80:150] and the same ground-truth box; percent-density,
    seed 7, zero elements excluded.  ``chw`` is the net's input shape; the
    box scales with it."""
    rng = np.random.RandomState(seed)
    C, H, W = chw
    pairs = []
    for _ in range(2):
        orig = (rng.rand(C, H, W) * 50).astype(np.float32)
        inp = orig + (rng.rand(C, H, W) * 30).astype(np.float32)
        pairs.append((orig, inp))

    def embed(ims):
        e = wb.embeddings(np.stack(ims))
        e = e / np.linalg.norm(e, axis=1, keepdims=True)
        m = e.mean(axis=0, keepdims=True)
        return m / np.linalg.norm(m, axis=1, keepdims=True)

    gals = [(embed([o + rng.rand(C, H, W).astype(np.float32)
                    for _ in range(2)]),
             embed([i + rng.rand(C, H, W).astype(np.float32)
                    for _ in range(2)]))
            for o, i in pairs]
    box = (slice(60 * H // SIZE, 120 * H // SIZE),
           slice(80 * W // SIZE, 150 * W // SIZE))
    smaps = []
    for _ in range(EVAL_MAPS):
        smap = rng.rand(H, W)
        smap[box] += 4.0
        smaps.append(smap / smap.sum())
    gt = np.zeros((H, W), bool)
    gt[box] = True
    return {"pairs": pairs, "gals": gals, "smaps": smaps, "gt": gt,
            "kw": dict(mask_threshold_method="percent-density",
                       percentiles=percentiles, seed=7,
                       include_zero_elements=False)}


def launch_eval_group(wb, w, p, refuse_syncs=False):
    """One probe group as bench.py's launch_group: the 4 maps of pair p
    into one TwinClsBatch, each map's host IoU curve computed after its
    launch, then the flush that enqueues the one multi-map program.
    Returns (finishes, IoU curves, host IoU seconds)."""
    from xfr_torch.inpainting_game import protocol as ipg

    orig, inp = w["pairs"][p % 2]
    og, ig = w["gals"][p % 2]
    batch = ipg.TwinClsBatch(wb, orig, inp, og, ig, **w["kw"])
    fins, ious, iou_s = [], [], 0.0
    for smap in w["smaps"]:
        with host_syncs_refused(refuse_syncs):
            fins.append(batch.launch(smap))
        t0 = time.time()
        kw = w["kw"]
        ious.append(ipg.intersect_over_union_thresholded_saliency(
            smap, w["gt"], kw["mask_threshold_method"],
            percentiles=kw["percentiles"], seed=kw["seed"],
            include_zero_elements=kw["include_zero_elements"]))
        iou_s += time.time() - t0
    with host_syncs_refused(refuse_syncs):
        batch.flush()
    return fins, ious, iou_s


def drain_eval_group(launched):
    """Finish a group and check it: every classification vector has T
    entries and a false first entry; distances and IoU curves finite."""
    fins, ious, _ = launched
    out = [f() for f in fins]
    T = len(ious[0])
    for (cls, pg, pr), iou in zip(out, ious):
        assert len(cls) == T and not cls[0], (len(cls), cls[:3])
        assert np.isfinite(pg).all() and np.isfinite(pr).all()
        assert np.isfinite(iou).all() and len(iou) == T
    return out


@contextlib.contextmanager
def blend_steps_counted(ranged=False):
    """Count the blend+encode steps and rows (one call of the engine's
    ``_threshold_blend`` per step) for a block; with ``ranged`` each call
    also runs in the profiler range "eval:blend"."""
    from torch.profiler import record_function
    from xfr_torch.ebp import engine

    fn = engine._threshold_blend
    count = {"steps": 0, "rows": 0}

    def counted(counts, t0, T, orig, inp, rows):
        count["steps"] += 1
        count["rows"] += rows.shape[0]
        if not ranged:
            return fn(counts, t0, T, orig, inp, rows)
        with record_function("eval:blend"):
            return fn(counts, t0, T, orig, inp, rows)

    engine._threshold_blend = counted
    try:
        yield count
    finally:
        engine._threshold_blend = fn


def eval_group_profile(wb, w):
    """One eval group launched and drained under torch.profiler, with the
    blend in its own range.  Returns (summary, kernel rows): the group's
    wall time, device busy time (every kernel and copy; one stream),
    idle share, device time by kernel group and of the blend's kernels,
    and the (device us, launches, kernel name) rows."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from tools.torch_strise_profile import group_of

    torch.cuda.synchronize()
    with blend_steps_counted(ranged=True) as count, \
            profile(activities=[ProfilerActivity.CPU,
                                ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        drain_eval_group(launch_eval_group(wb, w, 0))
        torch.cuda.synchronize()
        wall = time.time() - t0
    rows, blend = [], None
    for e in prof.key_averages():
        if e.key == "eval:blend":
            # the range's CUDA row is its span on the device's timeline,
            # not a kernel: only its CPU row's kernel time is kept
            if e.device_type == DeviceType.CPU:
                blend = {"ms": e.device_time_total / 1e3, "calls": e.count}
        elif e.device_type == DeviceType.CUDA and \
                e.self_device_time_total > 0:
            rows.append((e.self_device_time_total, e.count, e.key))
    rows.sort(reverse=True)
    busy_s = sum(r[0] for r in rows) / 1e6
    groups = {}
    for us, n, name in rows:
        g = groups.setdefault(group_of(name), {"ms": 0.0, "launches": 0})
        g["ms"] += us / 1e3
        g["launches"] += n
    for g in groups.values():
        g["share_of_busy"] = g["ms"] / 1e3 / busy_s
    blend["share_of_busy"] = blend["ms"] / 1e3 / busy_s
    return ({"group_s_profiled": wall, "device_busy_s": busy_s,
             "idle_share": 1.0 - busy_s / wall,
             "kernel_launches": sum(r[1] for r in rows),
             "blend": blend, "steps": count["steps"], "rows": count["rows"],
             "groups": dict(sorted(groups.items(),
                                   key=lambda kv: -kv[1]["ms"]))}, rows)


class _HostBlendOnly:
    """A net that shows only ``embeddings``: the protocol's host-blend
    branch (float64 blends on the host, encoded on the net's device)."""

    def __init__(self, wb):
        self.embeddings = wb.embeddings


def phase_eval_parity():
    """The eval core on the card and on the CPU with the same weights and
    the same galleries (encoded on the CPU): ResNet-101 at full widths,
    one block per stage, one probe/twin pair, bench.py's four maps, T cut
    to 21 percentiles so each map is one 32-row step.  On the card the
    multi-map program must equal each map's single-map program and the
    host-blend branch; card against CPU, the embeddings within 1e-2 of
    their largest entry (TF32 on the card) and the classifications equal
    wherever |pg - pr| on the CPU exceeds twice the largest per-row L2 gap
    of the embeddings (a distance moves by at most that gap)."""
    from xfr_torch.inpainting_game import protocol as ipg

    pct = np.linspace(0, 100, 21)
    wbs = {dev: whitebox_net(dev, layers=(1, 1, 1, 1))
           for dev in ("cpu", "cuda")}
    w = eval_workload(wbs["cpu"], seed=1, percentiles=pct)
    orig, inp = w["pairs"][0]
    og, ig = w["gals"][0]

    def multi(wb):
        batch = ipg.TwinClsBatch(wb, orig, inp, og, ig, **w["kw"])
        fins = [batch.launch(s) for s in w["smaps"]]
        batch.flush()
        return [f() for f in fins], batch._result

    secs = {}
    for dev in ("cuda", "cpu", "cuda"):  # the first card run warms up
        t0 = time.time()
        res, emb = multi(wbs[dev])
        secs[dev] = time.time() - t0
        if dev == "cpu":
            res_cpu, emb_cpu = res, emb
    card = wbs["cuda"]
    same_single, same_host, host_gap = True, True, 0.0
    for s, r in zip(w["smaps"], res):
        single = ipg.launch_classified_as_inpainted_twin(
            card, orig, inp, og, ig, s, **w["kw"])()
        host = ipg.classified_as_inpainted_twin(
            _HostBlendOnly(card), orig, inp, og, ig, s, **w["kw"])
        same_single &= all(np.array_equal(a, b) for a, b in zip(single, r))
        same_host &= all(np.array_equal(a, b) for a, b in zip(host, r))
        host_gap = max(host_gap, float(np.abs(host[1] - r[1]).max()),
                       float(np.abs(host[2] - r[2]).max()))
    emb_gap = float(np.abs(emb - emb_cpu).max() / np.abs(emb_cpu).max())
    row_gap = float(np.linalg.norm(emb - emb_cpu, axis=-1).max())
    below, disagree = 0, 0
    for (cls, _, _), (cls_c, pg_c, pr_c) in zip(res, res_cpu):
        sure = np.abs(pg_c - pr_c) > 2 * row_gap
        below += int((~sure).sum())
        disagree += int((cls[sure] != cls_c[sure]).sum())
    flips = [int(np.argmax(c)) if c.any() else None for c, _, _ in res]
    emit("eval_parity", T=len(pct), T_note="cut from 101 to 21 percentiles "
         "to keep the CPU side short", layers=[1, 1, 1, 1],
         multi_equals_single=same_single, multi_equals_host_blend=same_host,
         host_blend_max_dist_gap=host_gap, emb_max_err_rel_to_max=emb_gap,
         emb_max_row_l2_gap=row_gap, thresholds_below_margin=below,
         thresholds_compared=len(res) * len(pct) - below,
         cls_disagree=disagree, first_flip=flips, cuda_s=secs["cuda"],
         cpu_s=secs["cpu"],
         tol={"emb_max_err_rel_to_max": 1e-2,
              "cls_margin": "2 x emb_max_row_l2_gap"})
    if not (same_single and same_host and emb_gap <= 1e-2
            and disagree == 0):
        raise AssertionError("eval core: card paths or card and CPU "
                             "disagree")


def phase_eval():
    """bench.py's eval workload on full ResNet-101+L2 (TF32 encode): one
    warm-up group with every host sync refused during its four launches
    and its flush, then EVAL_GROUPS timed groups with one group in flight
    (group p+1 launched, its IoU curves computed, before group p drains);
    then one group alone, its steps and rows, and one profiled group."""
    import torch
    from xfr_torch.blackbox import fused_blend as FB

    t0 = time.time()
    wb = whitebox_net("cuda")
    w = eval_workload(wb)
    k1_before = FB.fused_mask_blend_preprocess.launches
    drain_eval_group(launch_eval_group(wb, w, 0, refuse_syncs=True))
    torch.cuda.synchronize()
    warm_s = time.time() - t0
    wb._upload_memo.clear()  # the first timed group pays its upload again

    torch.cuda.reset_peak_memory_stats()
    times, launch_s, iou_s = [], [], []

    def launch(p):
        tl = time.time()
        g = launch_eval_group(wb, w, p)
        launch_s.append(time.time() - tl)
        iou_s.append(g[2])
        return g

    t0 = time.time()
    pend = launch(0)
    for p in range(1, EVAL_GROUPS):
        nxt = launch(p)
        drain_eval_group(pend)
        t1 = time.time()
        times.append(t1 - t0)
        t0, pend = t1, nxt
    drain_eval_group(pend)
    times.append(time.time() - t0)
    peak = torch.cuda.max_memory_allocated()

    torch.cuda.synchronize()
    with blend_steps_counted() as count:
        t0 = time.time()
        g = launch_eval_group(wb, w, 1)
        one_launch = time.time() - t0
        drain_eval_group(g)
        one_group = time.time() - t0
    prof, _ = eval_group_profile(wb, w)
    k1 = FB.fused_mask_blend_preprocess.launches - k1_before
    T = len(w["kw"]["percentiles"])
    emit("eval", groups=EVAL_GROUPS, evals_per_group=EVAL_MAPS,
         interval_s=times, evals_per_s=EVAL_MAPS * EVAL_GROUPS / sum(times),
         warmup_s=warm_s, peak_mem_bytes=peak, launch_s=launch_s,
         host_iou_s=iou_s, one_group={"launch_s": one_launch,
                                      "group_s": one_group},
         steps_per_group=count["steps"], rows_per_group=count["rows"],
         rows_used=EVAL_MAPS * T, profile=prof, k1_launches=k1,
         encode_precision="TF32 allowed")
    if k1 != 0:
        raise AssertionError(f"the eval path launched K1 {k1} times")
    if count["rows"] != count["steps"] * wb.blend_batch:
        raise AssertionError(f"eval steps {count}")


# ---------------------------------------------------------------------------
# Inpainting-game generation stage (the generate_* CLIs' core)
# ---------------------------------------------------------------------------

GEN_JOBS, GEN_B, GEN_BB_JOBS = 19, 8, 2  # groups of 8, 8 and a padded 3
WSEBP_PATHS = {"fused": dict(return_subtree_maps=False),
               "host": dict(return_subtree_maps=True),
               # at one block per stage (59 candidates) 64 would take
               # every candidate: 32 keeps the walk over a subset
               "max_candidates": dict(max_candidates=32,
                                      return_subtree_maps=False)}


def phase_wsebp_parity():
    """The per-probe weighted_subtree_ebp on the card and on the CPU with
    the same weights and the same triplet classifier (encoded on the
    CPU): ResNet-101 at full widths, one block per stage, float32 sweep,
    top-32, norelu, each of the three paths.  Card against CPU: equal
    k_subtree_valid, scores within rtol 5e-5, maps within 1e-4 of their
    max (the CPU tests' limits at this depth).  On the card the fused
    per-probe map must equal the batched path's for the same probe and
    classifier (the same program on the same inputs: equal selections,
    maps within 1e-6 of their max)."""
    import torch

    wbs = {dev: whitebox_net(dev, layers=(1, 1, 1, 1))
           for dev in ("cpu", "cuda")}
    w = whitebox_workload(wbs["cpu"], 1, seed=3)
    for dev, wb in wbs.items():
        wb.net.set_triplet_classifier(w["em"].to(dev), w["en"].to(dev))
    res, secs = {}, {}
    for dev in ("cuda", "cpu", "cuda"):  # the first card pass warms up
        for name, kw in WSEBP_PATHS.items():
            t0 = time.time()
            res[dev, name] = wbs[dev].weighted_subtree_ebp(
                w["probes"].to(dev), 0, 1, topk=WB_TOPK,
                subtree_mode="norelu", **kw)
            if dev == "cuda":
                torch.cuda.synchronize()
            secs[dev, name] = time.time() - t0
    rec, ok = {}, True
    for name in WSEBP_PATHS:
        (s_c, m_c, sc_c, k_c), (s_p, m_p, sc_p, k_p) = (res["cuda", name],
                                                        res["cpu", name])
        same = k_c == k_p and len(m_c) == len(m_p)
        map_err = score_err = None
        if same:
            map_err = max(float(np.abs(a - b).max() / np.abs(b).max())
                          for a, b in zip([s_c] + m_c, [s_p] + m_p))
            score_err = float(np.max(np.abs(np.subtract(sc_c, sc_p)) /
                                     np.maximum(np.abs(sc_p), 1e-30)))
        rec[name] = {"selected": len(k_c), "same_subtrees": k_c == k_p,
                     "subtree_maps": len(m_c),
                     "map_max_err_rel_to_max": map_err,
                     "score_max_rel_err": score_err,
                     "cuda_s": secs["cuda", name],
                     "cpu_s": secs["cpu", name]}
        ok &= same and score_err <= 5e-5 and map_err <= 1e-4
        check_wb_maps({"weighted_subtree": [s_c]})
    card = wbs["cuda"]
    card.set_triplet_classifier_batch(w["em"].cuda()[None],
                                      w["en"].cuda()[None])
    s_b, _, sc_b, k_b = card.weighted_subtree_ebp_batch(
        w["probes"].cuda(), topk=WB_TOPK, subtree_mode="norelu")[0]
    s_f, _, sc_f, k_f = res["cuda", "fused"]
    batch_err = float(np.abs(s_b - s_f).max() / np.abs(s_f).max())
    same_batch = k_b == k_f and batch_err <= 1e-6
    emit("wsebp_parity", layers=[1, 1, 1, 1], paths=rec,
         batched_equals_per_probe={"same_subtrees": k_b == k_f,
                                   "map_max_err_rel_to_max": batch_err,
                                   "scores_equal": sc_b == sc_f},
         tol={"score_rtol": 5e-5, "map_err_rel_to_max": 1e-4,
              "batched_map_err_rel_to_max": 1e-6})
    if not (ok and same_batch):
        raise AssertionError(f"per-probe weighted subtree: {rec}, batched "
                             f"equal {same_batch} ({batch_err})")


def generation_jobs(n, seed=0):
    """n in-memory whitebox jobs with every method to write: a random
    224x224 probe, two mates and two nonmates each."""
    todo = dict.fromkeys(("meanEBP", "contrastive", "trunc",
                          "weighted-subtree"), True)
    jobs = []
    for i in range(n):
        ims = _images(seed + i, 5)
        jobs.append({"label": ("job", i), "todo": dict(todo),
                     "images": (ims[0], ims[1:3], ims[3:5])})
    return jobs


def npz_writer(out_dir, written):
    """A write(job, slug_key, smap) callback: create_save_smap's
    normalization (shift to 0, unit mass) and its npz, no PNG."""
    import os

    def write(job, key, smap):
        smap = np.array(smap, np.float32)
        smap -= smap.min()
        total = smap.sum()
        if total > 0:
            smap /= total
        np.savez_compressed(os.path.join(out_dir, "%s-%d-%s.npz" % (
            job["label"][0], job["label"][1], key)), saliency_map=smap)
        written.append(smap)

    return write


def phase_generate():
    """The generation stage on full ResNet-101+L2 with the CLIs' defaults
    (net "resnetv4_pytorch", ebp_version 6, bfloat16 sweep, float32
    contrastive, weighted subtree in the net's norelu mode, batch 8,
    score precision "high")."""
    import tempfile

    import torch
    from xfr_torch.blackbox import fused_blend as FB
    from xfr_torch.blackbox.strise import STRise
    from xfr_torch.inpainting_game import generate as G
    from xfr_torch.models import create_wbnet

    t0 = time.time()
    wb = create_wbnet("resnetv4_pytorch", ebp_version=6, device="cuda")
    wb.wsebp_dtype = torch.bfloat16
    mode = wb.ebp_subtree_mode()
    net_s = time.time() - t0
    k1_before = FB.fused_mask_blend_preprocess.launches

    host = {"resolve_s": 0.0, "write_s": 0.0}

    def resolve(j):
        t = time.time()
        probe, mates, nonmates = j["images"]
        j = G.prepare_wb_job(wb, j, probe, mates, nonmates)
        host["resolve_s"] += time.time() - t
        return j

    tmp = tempfile.TemporaryDirectory()
    written = []
    save = npz_writer(tmp.name, written)

    def write(job, key, smap):
        t = time.time()
        save(job, key, smap)
        host["write_s"] += time.time() - t

    # one warm-up group, every host sync refused during its launch
    t0 = time.time()
    group = [resolve(j) for j in generation_jobs(GEN_B, seed=100)]
    with host_syncs_refused(True):
        st = G.launch_wb_group(wb, group, GEN_B, mode, 6)
    G.drain_wb_group(wb, st, write)
    torch.cuda.synchronize()
    warm_s = time.time() - t0

    # the batched generator's double-buffered groups
    written.clear()
    host.update(resolve_s=0.0, write_s=0.0)
    failures = []
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    done = G.run_wb_groups(wb, generation_jobs(GEN_JOBS), resolve, write,
                           GEN_B, mode, 6, failures=failures)
    torch.cuda.synchronize()
    wb_s = time.time() - t0
    wb_peak = torch.cuda.max_memory_allocated()
    wb_host = dict(host)
    n_maps = len(written)
    check_wb_maps({"weighted_subtree": written})
    if failures or done != GEN_JOBS or n_maps != 4 * GEN_JOBS:
        raise AssertionError(f"batched generation: {done} jobs, {n_maps} "
                             f"maps, failures {failures}")

    # one probe through the serial method functions
    probe, mates, nonmates = generation_jobs(1, seed=200)[0]["images"]
    serial = {}

    def timed(name, fn):
        """The method twice: its first call, then a timed call with its
        peak memory."""
        t = time.time()
        fn()
        torch.cuda.synchronize()
        first = time.time() - t
        torch.cuda.reset_peak_memory_stats()
        t = time.time()
        m = fn()
        torch.cuda.synchronize()
        serial[name] = {"first_s": first, "s": time.time() - t,
                        "peak_mem_bytes": torch.cuda.max_memory_allocated()}
        check_wb_maps({"weighted_subtree": [m]})

    timed("meanEBP", lambda: G.mean_ebp(wb, probe))
    timed("contrastive", lambda: G.run_contrastive_triplet_ebp(
        wb, mates, nonmates, probe, None))
    timed("trunc", lambda: G.run_contrastive_triplet_ebp(
        wb, mates, nonmates, probe, G.TRUNCATE_PERCENT))
    for mc in (None, 64):
        timed("weighted-subtree max_candidates=%s" % mc,
              lambda mc=mc: G.run_weighted_subtree_triplet_ebp(
                  wb, mates, nonmates, probe, mode, topk=G.WSEBP_TOPK,
                  ebp_version=6, max_candidates=mc))
    wb.net.reset_classifier()

    # blackbox jobs through one BBPipeline with the built-in matcher; the
    # resident net also serves the mean-EBP prior, as the BB CLI aliases it
    net_dict = {("resnetv4_pytorch", 6): wb, ("resnetv4_pytorch", None): wb}
    bb_jobs = [_images(300 + i, 5) for i in range(GEN_BB_JOBS)]
    kw = dict(rise_scale=SCALE, num_mask_elements=ELEMS,
              mask_fill_type="blur", blur_sigma_percent=4, device="cuda",
              num_masks=N_MASKS, prior_type="mean_ebp",
              score_precision="high")
    bb_maps = {}

    def bb_writer(i, finish):
        def run():
            bb_maps[i] = finish()
            write({"label": ("bb", i)}, "bbox-rise", bb_maps[i])
        return run

    pipe = G.BBPipeline()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    for i, ims in enumerate(bb_jobs):
        finish = G.create_bbox(("resnetv4_pytorch", net_dict), ims[0],
                               ims[1:3], ims[3:5], seed=i, **kw).launch()
        pipe.push(bb_writer(i, finish), label=("bb", i))
    pipe.drain()
    torch.cuda.synchronize()
    bb_s = time.time() - t0
    bb_peak = torch.cuda.max_memory_allocated()
    if pipe.failures or len(bb_maps) != GEN_BB_JOBS:
        raise AssertionError(f"blackbox pipeline failures {pipe.failures}")
    bb_rec = []
    for i, ims in enumerate(bb_jobs):
        st_e = STRise(probe=ims[0], refs=ims[1:3], gallery=ims[3:5],
                      black_box="resnetv4_pytorch", net_dict=net_dict,
                      mask_scale=SCALE, num_mask_elements=ELEMS,
                      mask_fill_type="blur", blur_fill_sigma_percent=4,
                      num_masks=N_MASKS, seed=i, prior_type="mean_ebp",
                      device="cuda", score_precision="high")
        st_e.evaluate()
        check_map(bb_maps[i])
        # as in phase_branches: one float32 step near 1.0 of the raw map
        # is q of the range-normalized map
        raw = st_e.combine_masks(st_e.mask_scores > 0)
        q = float(np.spacing(np.float32(0.5)) / (raw.max() - raw.min()))
        bb_rec.append({
            "map_max_abs_diff": float(np.abs(
                bb_maps[i] - st_e.saliency_map).max()),
            "map_f32_step": q, "tol": 1e-3 + 4 * q,
            "corr": float(np.corrcoef(bb_maps[i].ravel(),
                                      st_e.saliency_map.ravel())[0, 1])})
    k1 = FB.fused_mask_blend_preprocess.launches - k1_before
    tmp.cleanup()
    emit("generate", net="resnetv4_pytorch", net_s=net_s,
         batched={"jobs": GEN_JOBS, "batch": GEN_B, "maps": n_maps,
                  "s": wb_s, "maps_per_s": n_maps / wb_s,
                  "warmup_group_s": warm_s, "peak_mem_bytes": wb_peak,
                  "maps_computed": 4 * GEN_B * -(-GEN_JOBS // GEN_B),
                  "host": wb_host, "wsebp_dtype": "bfloat16"},
         serial=serial,
         blackbox={"jobs": GEN_BB_JOBS, "masks": N_MASKS, "s": bb_s,
                   "maps_per_s": GEN_BB_JOBS / bb_s,
                   "peak_mem_bytes": bb_peak, "vs_evaluate": bb_rec,
                   "score_precision": "high"},
         k1_launches=k1)
    if k1 != 0:
        raise AssertionError(f"the generation path launched K1 {k1} times")
    if any(r["map_max_abs_diff"] > r["tol"] for r in bb_rec):
        raise AssertionError(f"BBPipeline maps against evaluate(): {bb_rec}")


# ---------------------------------------------------------------------------
# The other matchers and the rest of the whitebox API
# ---------------------------------------------------------------------------

VARIANT_LWC_MODES = ("copy", "mean", "product", "argmax", "argmax_product",
                     "percentile", "percentile_argmax", "elementwise")


def parity_net(name):
    """One matcher of models_parity, built once on the CPU from the numpy
    init of seed 7: (graph, params, encode tensor, classifier name,
    classes, subtree mode, input CHW, compute dtypes).

    SENet-50-256 and VGG-16 are compared in float64 first: at these
    random weights their float32 results are ill-conditioned.  SENet's SE
    gates take sigmoids of 1x1 convolutions of pooled activations near
    1e3, which cancel: its float32 embedding lies 12-17% of its max from
    float64 on the CPU alone.  VGG-16's float32 EBP map lies 1.0e-3 of its
    max from float64 on the CPU."""
    from xfr_torch.models import common
    from xfr_torch.models import lightcnn as LCNN
    from xfr_torch.models import vggface as VGG
    from xfr_torch.models import vggface2 as VF2

    import torch

    f32, f64 = (torch.float32,), (torch.float64, torch.float32)
    if name == "lightcnn":
        built = LCNN.build_lightcnn29v2(layers=(1, 1, 1, 1))
        rest = ("fc2", 80013, "affineonly_with_prior", (1, 128, 128), f32)
    elif name == "resnet50_128":
        built = VF2.build_resnet50_128()
        rest = ("fc1", 2, "norelu", (3, SIZE, SIZE), f32)
    elif name == "senet50_256":
        built = VF2.build_senet50_256()
        rest = ("fc1", 2, "norelu", (3, SIZE, SIZE), f64)
    else:
        built = VGG.build_vgg16()
        rest = ("fc8", 2622, "norelu", (3, SIZE, SIZE), f64)
    graph, shapes, enc = built
    return (graph, common.init_params(shapes, seed=7), enc) + rest


def parity_outputs(name, wb, x, nc, triplet):
    """models_parity's results of one matcher on one device and dtype:
    embedding, logits, ebp (or whether it raised), the contrastive pair
    and, for LightCNN, weighted-subtree top-32 under ``triplet``."""
    import torch
    from xfr_torch.utils.device import precision_scope

    with precision_scope("high"):
        o = {"embedding": wb.net.encode(x).double().cpu().numpy(),
             "logits": wb.net.classify(x).double().cpu().numpy()}
    if name == "senet50_256":
        try:
            wb.ebp(x, np.eye(nc, dtype=np.float32)[:1])
            o["ebp_raises"] = False
        except ValueError as e:
            o["ebp_raises"] = "special case" in str(e)
    else:
        o["ebp"] = wb.ebp(x, np.eye(nc, dtype=np.float32)[:1], mwp=True)
    if name in ("lightcnn", "resnet50_128"):
        o["contrastive"] = wb.contrastive_ebp(x, 0, 1)
        o["truncated_contrastive"] = wb.truncated_contrastive_ebp(
            x, 0, 1, percentile=20)
    if name == "lightcnn":
        wb.net.set_triplet_classifier(*(t.to(x) for t in triplet))
        s, _, sc, k = wb.weighted_subtree_ebp(
            x, 0, 1, topk=WB_TOPK, subtree_mode=wb.ebp_subtree_mode(),
            return_subtree_maps=False)
        wb.net.reset_classifier()
        o["weighted_subtree"] = (s, k, sc)
    if x.is_cuda:
        torch.cuda.synchronize()
    return o


def phase_models_parity():
    """The four other matchers on the card and on the CPU with the same
    numpy weights and input (TF32 off): LightCNN-29 v2 at full widths and
    80,013 classes, one block a stage, and ResNet-50-128 whole, in
    float32; SENet-50-256 and VGG-16 whole, in float64 and in float32
    (see parity_net).  Float32: embedding and logits within 1e-4 of their
    largest entry, ebp's channel-pooled map (class 0) within 1e-3 of its
    max, the contrastive pair (classes 0 and 1) at correlation >= 0.999
    (wb_parity's limits); LightCNN's weighted-subtree top-32 in its
    affineonly_with_prior mode, float32 sweep, under one triplet
    classifier encoded on the CPU: the same subtrees, scores at rtol 1e-4,
    maps within 1e-4 of their max (wsebp_parity's check).  Float64:
    embedding and logits within 1e-7 (SENet's cancelling gates read
    2.6e-9 there), the EBP map (float32 out, as every EBP program casts
    it) within 1e-6.  SENet-50-256 and VGG-16 in float32: the card's
    results against the float64 CPU's, within 3 times the CPU's own
    float32 error and at least the float32 limits above.  VGG-16: encode
    and one EBP.  SENet: encode, and its EBP must raise on the Sigmoid."""
    import torch
    from xfr_torch.ebp.engine import Whitebox, WhiteboxNetwork
    from xfr_torch.models import common

    def err(a, b):
        return float(np.abs(a - b).max() / np.abs(b).max())

    f32, f64 = torch.float32, torch.float64
    rec, ok = {}, True
    k1_0 = k1_launches()
    for name in ("lightcnn", "resnet50_128", "senet50_256", "vgg16"):
        graph, params, enc, cls, nc, mode, chw, dts = parity_net(name)
        x = np.random.RandomState(3).rand(1, *chw).astype(np.float32)
        if chw[0] == 3:
            x *= 50
        out, secs, triplet = {}, {}, None
        for dt in dts:
            for dev in ("cpu", "cuda"):  # the CPU encodes the triplet
                wb = Whitebox(WhiteboxNetwork(
                    graph, common.params_to(params, dev, dtype=dt),
                    encode_tensor=enc, classifier_pname=cls, num_classes=nc),
                    ebp_version=6, ebp_subtree_mode=mode)
                xd = torch.from_numpy(x).to(device=dev, dtype=dt)
                if name == "lightcnn" and triplet is None:
                    e = wb.net.encode(torch.as_tensor(
                        np.random.RandomState(11).rand(2, *chw), dtype=dt))
                    triplet = (e[0] / e[0].norm(), e[1] / e[1].norm())
                t0 = time.time()
                out[dev, dt] = parity_outputs(name, wb, xd, nc, triplet)
                secs[dev, dt] = time.time() - t0
                del wb
        r = {"nodes": len(graph.nodes), "events": graph.n_events,
             "classes": nc, "input": list(chw), "cuda_s": secs["cuda", f32],
             "cpu_s": secs["cpu", f32],
             "dtype": str(dts[0]).replace("torch.", "")}
        for k, a in out["cuda", dts[0]].items():
            b = out["cpu", dts[0]][k]
            if k == "ebp_raises":
                r[k] = bool(a and b)
                ok &= r[k]
            elif "contrastive" in k:
                r[k + "_corr"] = float(np.corrcoef(a.ravel(), b.ravel())[0, 1])
                ok &= r[k + "_corr"] >= 0.999
            elif k == "weighted_subtree":
                (s_c, k_c, sc_c), (s_p, k_p, sc_p) = a, b
                w = {"selected": len(k_c), "same_subtrees": k_c == k_p}
                if k_c == k_p:
                    w["map_err_rel_to_max"] = err(s_c, s_p)
                    w["score_max_rel_err"] = float(np.max(
                        np.abs(np.subtract(sc_c, sc_p))
                        / np.maximum(np.abs(sc_p), 1e-30)))
                ok &= (k_c == k_p and w["map_err_rel_to_max"] <= 1e-4
                       and w["score_max_rel_err"] <= 1e-4)
                r[k] = w
            else:
                r[k + "_err_rel_to_max"] = err(a, b)
                lim = {(True, True): 1e-6, (True, False): 1e-7,
                       (False, True): 1e-3, (False, False): 1e-4}
                ok &= (np.isfinite(a).all()
                       and err(a, b) <= lim[dts[0] == f64, k == "ebp"])
        if dts[0] == f64:
            # float32 on the card against float64 on the CPU
            r["float32"] = {}
            for k, ref in out["cpu", f64].items():
                if k == "ebp_raises":
                    continue
                cpu_err = err(out["cpu", f32][k], ref)
                lim = max(1e-3 if k == "ebp" else 1e-4, 3 * cpu_err)
                r["float32"][k] = {
                    "err_rel_to_max": err(out["cuda", f32][k], ref),
                    "cpu_err_rel_to_max": cpu_err, "limit": lim}
                ok &= (np.isfinite(out["cuda", f32][k]).all()
                       and r["float32"][k]["err_rel_to_max"] <= lim)
        rec[name] = r
    emit("models_parity", nets=rec, precision="high",
         tol={"float32": {"embedding_logits_err_rel_to_max": 1e-4,
                          "ebp_err_rel_to_max": 1e-3,
                          "contrastive_corr_min": 0.999,
                          "weighted_subtree_map_err_rel_to_max": 1e-4,
                          "weighted_subtree_score_rtol": 1e-4},
              "float64": {"embedding_logits_err_rel_to_max": 1e-7,
                          "ebp_err_rel_to_max": 1e-6},
              "float32_against_float64": "max(the float32 limit, 3 x the "
                                         "CPU's float32 error)"},
         k1_launches=k1_launches() - k1_0)
    check_no_k1("models_parity", k1_launches() - k1_0)
    if not ok:
        raise AssertionError(f"other matchers: card and CPU disagree: {rec}")


def lightcnn_workload(wb, B, seed=0):
    """B random 128x128 RGB probes in [0, 1] through
    preprocess_lightcnn_batch on the card, and the triplet encodings:
    unit-normed mean encodings of two mates and two nonmates made alike."""
    import torch
    from xfr_torch.models.lightcnn import preprocess_lightcnn_batch

    g = torch.Generator(device=wb.device).manual_seed(seed)

    def imgs(n):
        return preprocess_lightcnn_batch(torch.rand(
            (n, 128, 128, 3), generator=g, device=wb.device))

    mates, nonmates = imgs(2), imgs(2)
    em, en = (e / e.norm() for e in (wb.encode(mates).mean(0),
                                     wb.encode(nonmates).mean(0)))
    return {"probes": imgs(B), "em": em, "en": en}


def run_eval_group(wb, chw):
    """One TwinClsBatch group (4 maps x 101 percentiles on one probe/twin
    pair of ``chw``) after a warm-up group with host syncs refused during
    its launches and flush: its wall time, evals/s and peak memory."""
    import torch

    w = eval_workload(wb, chw=chw)
    drain_eval_group(launch_eval_group(wb, w, 0, refuse_syncs=True))
    torch.cuda.synchronize()
    wb._upload_memo.clear()
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    g = launch_eval_group(wb, w, 1)
    launch_s = time.time() - t0
    drain_eval_group(g)
    group_s = time.time() - t0
    return {"maps": EVAL_MAPS, "percentiles": len(EVAL_PCT),
            "input": list(chw), "launch_s": launch_s, "group_s": group_s,
            "evals_per_s": EVAL_MAPS / group_s,
            "peak_mem_bytes": torch.cuda.max_memory_allocated()}


def phase_lightcnn():
    """The slice's full-width path: create_wbnet("lightcnn") on the card
    (LightCNN-29 v2, layers (1,2,3,4), 80,013 classes, 88 events) runs the
    generation CLI's 4-map mix on B=8 random 128x128 probes in its
    affineonly_with_prior mode (bfloat16 sweep, float32 contrastive), as
    phase_whitebox runs it; then one eval group on a 1x128x128 pair."""
    import torch
    from xfr_torch.models import create_wbnet

    t0 = time.time()
    wb = create_wbnet("lightcnn", device="cuda")
    net_s = time.time() - t0
    graph = wb.net.graph
    n_params = sum(v.numel() for p in wb.net.params.values()
                   for v in p.values())
    if (wb.net.num_classes(), graph.n_events) != (80013, 88):
        raise AssertionError("LightCNN-29 v2: %d classes, %d events" % (
            wb.net.num_classes(), graph.n_events))
    wb.wsebp_dtype = torch.bfloat16
    k1_0 = k1_launches()
    mix = run_mix(wb, lightcnn_workload(wb, WB_B),
                  mode=wb.ebp_subtree_mode(), shape=(128, 128))
    ev = run_eval_group(wb, (1, 128, 128))
    k1 = k1_launches() - k1_0
    emit("lightcnn", net="lightcnn", net_s=net_s, nodes=len(graph.nodes),
         events=graph.n_events, classes=wb.net.num_classes(),
         params=n_params, mix=mix, eval_group=ev, k1_launches=k1)
    check_no_k1("LightCNN", k1)


def phase_vggface2():
    """The same mix on full VGGFace2 ResNet-50-128 (its 2-class fc1
    replaced by the interleaved [2B, 128] triplet classifier), norelu,
    B=8, bfloat16 sweep, float32 contrastive."""
    import torch
    from xfr_torch.models import create_wbnet

    t0 = time.time()
    wb = create_wbnet("vggface2_resnet50", device="cuda")
    net_s = time.time() - t0
    wb.wsebp_dtype = torch.bfloat16
    mix = run_mix(wb, whitebox_workload(wb, WB_B),
                  mode=wb.ebp_subtree_mode())
    emit("vggface2", net="vggface2_resnet50", net_s=net_s,
         nodes=len(wb.net.graph.nodes), events=wb.net.graph.n_events,
         mix=mix)


def variant_calls(wb, x, k_layer, k_element, percentile_mode=False):
    """name -> zero-argument call of each method of the rest of the
    whitebox API on probe ``x``, classes 0 (mate) and 1 (nonmate)."""
    calls = {"layerwise_ebp_argmax": lambda: wb.layerwise_ebp(
        x, k_layer=k_layer, mode="argmax", k_poschannel=0)}
    for m in VARIANT_LWC_MODES:
        calls["layerwise_contrastive_" + m] = \
            lambda m=m: wb.layerwise_contrastive_ebp(
                x, 0, 1, k_layer=k_layer, mode=m, percentile=80,
                k_element=k_element)
    for topk in (1, 8):
        calls["subtree_percentile_argmax_top%d" % topk] = \
            lambda topk=topk: wb.subtree_ebp(x, 0, 1, topk=topk)
    if percentile_mode:
        calls["subtree_percentile_top8"] = lambda: wb.subtree_ebp(
            x, 0, 1, mode="percentile", topk=8)
    return calls


def _variant_map(res):
    """(map, selection or None) of a variant call's result."""
    if isinstance(res, tuple):
        return np.asarray(res[0], np.float32), (list(res[2]), list(res[1]))
    return np.asarray(res, np.float32), None


def phase_variants():
    """The rest of the whitebox API on one probe: on full ResNet-101
    ("resnetv4_pytorch") layerwise_ebp, the 8 layerwise_contrastive_ebp
    modes at event 38 (a Conv2d event: at event 37, a ReLU, the norelu
    mode passes the zero incoming gradient and drops the prior, so every
    map is zero, as in the JAX package's goldens) and subtree_ebp
    (percentile_argmax, top 1 and 8), each called once to warm up, then
    timed, every map non-zero; at one block a stage the same calls at
    event 37 (a BatchNorm there) plus subtree_ebp(mode="percentile") on
    the card and on the CPU, same weights, in float64 and in float32.
    Float64: the same selections, scores at rtol 1e-9, maps within 1e-6
    of their max (maps come out in float32).  Float32: the card's maps
    within 1e-4 of the float64 CPU maps' max, and the same selections and
    scores at rtol 1e-4 as the float32 CPU's (float32 against float64,
    the selections may order equal scores otherwise).  The CPU's own
    float32 error is recorded beside, and the number of the stem max
    pool's windows whose first maximum lies elsewhere in float32 than in
    float64, on each device.  Then STRise's uint8 prior (ebp_version 5)
    on the card against the CPU, within 2 uint8 steps of its max."""
    import torch
    import torch.nn.functional as F
    from xfr_torch.blackbox.strise import STRise
    from xfr_torch.ebp.engine import Whitebox
    from xfr_torch.models import create_wbnet
    from xfr_torch.utils.device import precision_scope

    warnings.filterwarnings("ignore", message=".*is deprecated.*")
    k1_0 = k1_launches()
    rng = np.random.RandomState(5)
    x = torch.as_tensor(rng.rand(1, 3, SIZE, SIZE) * 50, dtype=torch.float32)

    def peak_element(wb, xd, k):
        P = wb._ebp_raw_fn((k,))(wb.net.params, xd, wb._onehot(0))[k]
        return int(P.reshape(-1).argmax())

    # full depth, the card alone
    wb = create_wbnet("resnetv4_pytorch", device="cuda")
    xc = x.cuda()
    k_full = 38
    k_el = peak_element(wb, xc, k_full)
    full = {}
    for name, call in variant_calls(wb, xc, k_full, k_el).items():
        call()
        torch.cuda.synchronize()
        t0 = time.time()
        m, sel = _variant_map(call())
        full[name] = {"s": time.time() - t0, "max": float(m.max())}
        if sel is not None:
            full[name]["subtrees"] = sel[0]
        if not np.isfinite(m).all() or m.min() < 0 or not m.max() > 0:
            raise AssertionError(f"variant {name}: bad map {full[name]}")
    event_tag = wb.net.graph.events[k_full].tag
    del wb

    # reduced depth, card against CPU, float64 first so that the float32
    # card times are taken warm
    f32, f64 = torch.float32, torch.float64
    wbs = {(dev, dt): whitebox_net(dev, layers=(1, 1, 1, 1), dtype=dt)
           for dt in (f64, f32) for dev in ("cuda", "cpu")}
    k_el = peak_element(wbs["cpu", f32], x, 37)
    res, secs = {}, {}
    for (dev, dt), wb in wbs.items():
        xd = x.to(device=dev, dtype=dt)
        for name, call in variant_calls(wb, xd, 37, k_el,
                                        percentile_mode=True).items():
            t0 = time.time()
            res[dev, dt, name] = _variant_map(call())
            secs[dev, dt, name] = time.time() - t0

    def map_err(a, b):
        return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))

    def score_err(a, b):
        return float(np.max(np.abs(np.subtract(a, b))
                            / np.maximum(np.abs(b), 1e-30)))

    reduced, ok = {}, True
    for (dev, dt, name), (m_c, sel_c) in res.items():
        if (dev, dt) != ("cuda", f32):
            continue
        (m64c, sel64c), (m64p, sel64p), (m_p, sel_p) = (
            res["cuda", f64, name], res["cpu", f64, name],
            res["cpu", f32, name])
        r = {"float64_map_err_rel_to_max": map_err(m64c, m64p),
             "float32_map_err_rel_to_max": map_err(m_c, m64p),
             "cpu_float32_map_err_rel_to_max": map_err(m_p, m64p),
             "cuda_s": secs["cuda", f32, name],
             "cpu_s": secs["cpu", f32, name]}
        good = (r["float64_map_err_rel_to_max"] <= 1e-6
                and r["float32_map_err_rel_to_max"] <= 1e-4)
        if sel_c is not None:
            r["subtrees"] = sel_c[0]
            r["same_subtrees"] = (sel64c[0] == sel64p[0]
                                  and sel_c[0] == sel_p[0])
            r["float64_score_max_rel_err"] = score_err(sel64c[1], sel64p[1])
            r["float32_score_max_rel_err"] = score_err(sel_c[1], sel_p[1])
            good &= (r["same_subtrees"]
                     and r["float64_score_max_rel_err"] <= 1e-9
                     and r["float32_score_max_rel_err"] <= 1e-4)
        r["ok"] = bool(good)
        ok &= good
        reduced[name] = r

    # why float32 maps stand further from float64 on the card than on the
    # CPU: the stem's 3x3 max pool routes each window's MWP to its first
    # maximum, and a near-tie within float32 rounding may lie elsewhere
    def first_max(dev, dt):
        wb = wbs[dev, dt]
        node = next(n for n in wb.net.graph.nodes if n.op == "maxpool2d")
        a = node.attrs_dict
        with precision_scope("high"):
            values = wb._capture(wb.net.params, x.to(device=dev, dtype=dt))[1]
        return F.max_pool2d(values[node.ins[0]], a["kernel"], a["stride"],
                            a["padding"], ceil_mode=a["ceil_mode"],
                            return_indices=True)[1].cpu()

    idx64 = first_max("cpu", f64)
    maxpool_moved = {"windows": idx64.numel(), **{
        dev + "_float32": int((first_max(dev, f32) != idx64).sum())
        for dev in ("cuda", "cpu")}}

    # STRise's uint8 mean-EBP prior, reduced depth, card against CPU
    probe, ref, gal = _images(6, 3)
    priors = {}
    for dev in ("cuda", "cpu"):
        wb = wbs[dev, f32]
        wb5 = Whitebox(wb.net, ebp_version=5, ebp_subtree_mode="norelu")
        st = STRise(probe=probe, refs=[ref], gallery=[gal],
                    black_box="resnetv6_pytorch", device=dev,
                    net_dict={("resnetv4_pytorch", None): wb5})
        st.mean_ebp_prior()
        priors[dev] = st.prior.cpu().numpy()
    pmax = float(np.abs(priors["cpu"]).max())
    prior_err = float(np.abs(priors["cuda"] - priors["cpu"]).max())
    ok &= prior_err <= 2 * pmax / 255 and pmax > 100
    emit("variants", k_layer={"full": k_full, "full_tag": event_tag,
                              "reduced": 37}, classes=[0, 1],
         full_depth=full, reduced_depth=reduced,
         stem_maxpool_windows_moved_from_float64=maxpool_moved,
         uint8_prior={"max_abs_diff": prior_err, "max": pmax,
                      "shape": list(priors["cuda"].shape)},
         tol={"float64_map_err_rel_to_max": 1e-6,
              "float32_map_err_rel_to_max": 1e-4,
              "float64_score_rtol": 1e-9, "float32_score_rtol": 1e-4,
              "uint8_prior_abs": "2 uint8 steps of its max"},
         k1_launches=k1_launches() - k1_0)
    check_no_k1("variants", k1_launches() - k1_0)
    if not ok:
        raise AssertionError(f"variants: card and CPU disagree: {reduced}, "
                             f"uint8 prior {prior_err} of {pmax}")


def phase_eccv20():
    """python -m xfr_torch.cli.eccv20 --figure 3 --subjects 2 on a
    synthetic 4-subject JPEG directory: full LightCNN-29 v2 on the card
    (ebp_version 5, affineonly_with_prior), every method; the six montages
    must exist with their grid's size."""
    import os
    import tempfile

    import PIL.Image
    from xfr_torch.cli import eccv20

    tmp = tempfile.TemporaryDirectory()
    data, out = (os.path.join(tmp.name, d) for d in ("data", "out"))
    os.makedirs(out)
    rng = np.random.RandomState(1)
    for sid in range(4):
        d = os.path.join(data, "s%02d" % sid)
        os.makedirs(d)
        base = (rng.rand(260, 260, 3) * 60 + 40).astype(np.uint8)
        base = np.roll(base, sid, axis=2)
        base[40 + 30 * sid:100 + 30 * sid, 60:200, sid % 3] = 240
        base[150:200, 40 + 40 * sid:90 + 40 * sid] = 30 + 60 * sid
        for k in range(3):
            img = np.clip(base.astype(int) + rng.randint(-10, 10, base.shape),
                          0, 255).astype(np.uint8)
            PIL.Image.fromarray(img).save(os.path.join(d, "im%d.jpg" % k))
    k1_0 = k1_launches()
    t0 = time.time()
    outs = eccv20.main(["--dataset", data, "--output", out, "--figure", "3",
                        "--subjects", "2"])
    secs = time.time() - t0
    k1 = k1_launches() - k1_0
    want = {"figure3%s_2.jpg" % c: (3 * 113, (6 if c == "f" else 3) * 113)
            for c in "abcdef"}
    sizes = {os.path.basename(f): PIL.Image.open(f).size for f in outs}
    tmp.cleanup()
    emit("eccv20", figure=3, subjects=2, net="lightcnn", s=secs,
         files=sizes, k1_launches=k1)
    check_no_k1("eccv20", k1)
    if sizes != want:
        raise AssertionError(f"eccv20 montages {sizes}, expected {want}")


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2
    import xfr_torch  # noqa: F401  (fails here outside a checkout)

    # a batched vjp that fell back to a per-row loop would say so
    warnings.filterwarnings("error", message=".*performance drop.*")
    t_start = time.time()
    smi = phase_device()
    phase_build()
    k1 = phase_kernel()
    phase_precision()
    phase_prior()
    wb, make, st_k, launches = main_path()
    phase_branches(make, st_k)
    phase_tf32(make, st_k)
    phase_breakdown(wb, make, k1["ms"])
    k1["launches"] = launches
    del wb, make, st_k
    phase_wb_parity()
    wb, w = phase_whitebox()
    phase_wsebp_bf16(wb, w)
    del wb, w
    phase_eval_parity()
    phase_eval()
    phase_wsebp_parity()
    phase_generate()
    phase_models_parity()
    phase_lightcnn()
    phase_vggface2()
    phase_variants()
    phase_eccv20()
    emit("done", seconds=time.time() - t_start)
    print(smi, flush=True)
    print(json.dumps({"kernels": [k1]}), flush=True)
    result = {"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
