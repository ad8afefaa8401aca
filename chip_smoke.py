#!/usr/bin/env python3
"""Drive the xfr_torch port's main path on one CUDA card and check it.

    python3 chip_smoke.py

Phases, one JSON line each; a failing phase raises, the script exits
non-zero and prints no result line:

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

The last lines are the card's name and power limit, the "kernels" line
and {"ok": true, "device": {...}}.
"""

import contextlib
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


def whitebox_net(device, layers=None, seed=2):
    """The whitebox matcher: full-depth ResNet-101+L2 from the factory, or
    one with ``layers`` blocks per stage and the numpy init of ``seed``."""
    from xfr_torch.ebp.engine import Whitebox, WhiteboxNetwork
    from xfr_torch.models import common, create_wbnet
    from xfr_torch.models import resnet101 as R101

    if layers is None:
        return create_wbnet("resnetv6_pytorch", device=device)
    graph, shapes, enc = R101.build_resnet101(layers=layers)
    net = WhiteboxNetwork(
        graph, common.params_to(common.init_params(shapes, seed=seed), device),
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


def launch_mix(wb, w, refuse_syncs=False):
    """Enqueue the 4-map mix as bench.py does: every method's device work
    before any host read; the classifier swaps between launches are safe
    because each launch takes the params it was given."""
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
            probes, topk=WB_TOPK, subtree_mode="norelu")
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


def check_wb_maps(out):
    for name in ("mean_ebp", "contrastive", "truncated_contrastive",
                 "weighted_subtree"):
        for m in out[name]:
            assert m.shape == (112, 112), (name, m.shape)
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


def stage_event_ms(wb, w):
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
    with subtree_mode(wb, "norelu"):
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


def sweep_launches_per_probe(wb, w):
    """Kernels and ATen operator calls of one B-probe sweep+select+merge,
    from torch.profiler, per probe; and the sweep's peak memory (the net,
    the probes and the ranking pass's outputs included)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    probes, em, en = w["probes"], w["em"], w["en"]
    B = probes.shape[0]
    wb.set_triplet_classifier_batch(em.expand(B, -1), en.expand(B, -1))
    with subtree_mode(wb, "norelu"):
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


def phase_whitebox():
    """bench.py's whitebox mix on full ResNet-101+L2: B=8, bfloat16 sweep,
    one warm-up mix with host syncs refused during the launches, then
    WB_TIMED mixes launched and drained double-buffered."""
    import torch
    from xfr_torch.blackbox import fused_blend as FB

    t0 = time.time()
    wb = whitebox_net("cuda")
    wb.wsebp_dtype = torch.bfloat16
    w = whitebox_workload(wb, WB_B)
    k1_before = FB.fused_mask_blend_preprocess.launches
    out = drain_mix(wb, launch_mix(wb, w, refuse_syncs=True))
    torch.cuda.synchronize()
    warm_s = time.time() - t0
    check_wb_maps(out)

    torch.cuda.reset_peak_memory_stats()
    times, launch_s, drain_s = [], [], []
    t0 = time.time()
    tl = time.time()
    prev = launch_mix(wb, w)
    launch_s.append(time.time() - tl)
    for _ in range(WB_TIMED - 1):
        tl = time.time()
        st = launch_mix(wb, w)
        launch_s.append(time.time() - tl)
        td = time.time()
        check_wb_maps(drain_mix(wb, prev))
        drain_s.append(time.time() - td)
        t1 = time.time()
        times.append(t1 - t0)
        t0, prev = t1, st
    td = time.time()
    check_wb_maps(drain_mix(wb, prev))
    drain_s.append(time.time() - td)
    times.append(time.time() - t0)
    peak = torch.cuda.max_memory_allocated()

    # one mix alone: the launch call against the whole mix
    torch.cuda.synchronize()
    t0 = time.time()
    st = launch_mix(wb, w)
    one_launch = time.time() - t0
    drain_mix(wb, st)
    one_mix = time.time() - t0

    stages = stage_event_ms(wb, w)
    sweep = sweep_launches_per_probe(wb, w)
    k1 = FB.fused_mask_blend_preprocess.launches - k1_before
    wb.net.reset_classifier()
    # as in bench.py, interval i ends with mix i's drain while mix i+1 is
    # queued; the intervals add up to the WB_TIMED mixes
    emit("whitebox", batch=WB_B, maps_per_mix=4 * WB_B, mixes=WB_TIMED,
         interval_s=times, maps_per_s=4 * WB_B * WB_TIMED / sum(times),
         warmup_s=warm_s, peak_mem_bytes=peak, launch_s=launch_s,
         drain_s=drain_s, one_mix={"launch_s": one_launch,
                                   "mix_s": one_mix},
         stage_event_ms=stages, sweep=sweep, wsebp_dtype="bfloat16",
         k1_launches=k1)
    if k1 != 0:
        raise AssertionError(f"the whitebox mix launched K1 {k1} times")
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
    emit("done", seconds=time.time() - t_start)
    print(smi, flush=True)
    print(json.dumps({"kernels": [k1]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
