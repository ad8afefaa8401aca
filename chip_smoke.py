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
  epilogue   the fused conv-bias/BatchNorm/gate/add/ReLU epilogue: each
             distinct chain of one 64-row full-depth ResNet-101 encode (NCHW
             and channels_last) and SENet-50-256 encode (channels_last)
             against its plain version bit for bit, its time beside its
             byte bound and the plain version's time, summed an encode;
             and the whole encode, captured, op by op against planned
  precision  precision_scope: full float32 under "high", TF32 under None;
             the host CPU's float32 conv and matmul against float64, timed,
             and its oneDNN settings
  prior      the mean-EBP prior on the card vs the plain path on the CPU
             (ResNet-101 at full widths, 65,359 classes, layers (1,1,1,1))
  main       STRise on full ResNet-101+L2 with random weights: 6,500
             masks, mean-EBP prior, blur fill 4%, scale 12, 2 elements,
             the fused-blend kernel, score_precision "high"; one warm-up
             map of 640 masks, then 1 timed map, launched with every host
             sync refused; the kernel must launch 102 times a map, and
             the fused epilogue run 103 encodes' chains a map (102
             chunk replays and the probe's encode)
  branches   the same seed and prior on the materialized-mask branch:
             the same masks, agreeing scores and maps
  uniform_draws  STRise's uniform-prior masks of seeds 0 and 1 on the card
             and on the CPU: the same bits
  tf32       seed 1's map with score_precision=None (TF32 allowed), twice
  breakdown  where one map's time goes, on seed 1's map again
  pipeline   seed 1 at "high" on the materialized-mask path (bench.py's),
             launched with every host sync refused: map seconds beside
             main's; one chunk's encode on each path's blend layout
  wb_parity  bench.py's whitebox 4-map mix (mean-EBP, contrastive,
             truncated-contrastive, weighted-subtree top-32) on the card
             and on the CPU, same weights: ResNet-101 at full widths with
             one block per stage, B=2, float32 sweep
  whitebox   the same mix on full ResNet-101+L2, B=8, bfloat16 sweep: one
             warm-up mix with every host sync refused during the launches,
             then 2 timed mixes launched and drained as bench.py does;
             maps/s, peak memory, each stage's CUDA-event time, the host
             drain, launch against mix time (the sweep's kernels by device
             time: tools/torch_whitebox_profile.py)
  wsebp_bf16 one full-depth probe's weighted-subtree map, bfloat16 sweep
             against float32 sweep
  bench      bench_torch.run through its real code on the same net at
             reduced counts (2 timed mixes, 2 STRise maps at None and at
             "high", 3 eval groups), its exact checks, its five lines
  eval_parity the inpainting game's evaluation core (TwinClsBatch: the
             blend+encode of every threshold mask, twin classification) on
             the card and on the CPU, same weights: ResNet-101 at full
             widths with one block per stage, one probe/twin pair,
             bench.py's four maps, T cut to 21 percentiles; on the card the
             multi-map, single-map and host-blend paths must agree
  eval       bench.py's eval workload (bench.py:117-194) on full
             ResNet-101+L2: 2 probe/twin pairs, 4 maps, 101 percentiles;
             one warm-up group with every host sync refused during its
             launches and flush, then 4 timed groups with one in flight;
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
  detect_parity the Faster R-CNN face detector's network on the card and
             on the CPU, same weights (detector_params), on a
             synthetic 600x800 uint8 image at the default 800 px (blob
             800x1067, res4 50x67, 30,150 anchors): trunk features, RPN
             probabilities and deltas, and the top's bbox_pred and
             cls_prob on the CPU's RoIs, each within 1e-4 of its max; the
             final detections where their scores are separated by 1e-4
  detect     FasterRCNN(conf_threshold=-1.0) at full width on the card:
             one warm-up, 1 timed detect() call, one with rotate_flags=7
             and padding 10; the stages of one pass (trunk+RPN and top by
             CUDA events; the host proposal layer and roi_pool, the
             copies each way by host clock), RoIs, peak memory, the same
             under TF32; K1 must launch 0 times
  eccv20     python -m xfr_torch.cli.eccv20 --figure 3 --subjects 2 on a
             synthetic JPEG corpus, full LightCNN-29 v2 on the card; then
             with --use-detector, detect() counted on every image
  train_parity  one make_train_step step and one make_eval_step on
             ResNet-101+L2 at full widths (65,359 classes) with one block a
             stage, B=4, on the card ("high") and on the CPU, same weights,
             in float64 and float32: loss, every leaf's update, hits; the
             BN statistics bit-identical to their start
  train      fine-tuning on full ResNet-101+L2: a B=32 batch through
             TripletDataLoader and preprocess_resnet101, one warm-up and 5
             timed steps under "high" and under None: step time (CUDA
             events), images/s, losses, peak memory, one profiled step's
             idle share; the same step through a (1, 1) mesh on a one-rank
             NCCL group against the plain step; K1 must launch 0 times
  mesh       the inference side's mesh forms on full ResNet-101+L2: the
             B=8 mix (bfloat16 sweep, host syncs refused during one mix's
             launches), one STRise map through K1 at "high" and one eval
             group, plain, then under a (1, 1) mesh on a one-rank NCCL
             group, then under a (2, 1) mesh of two processes sharing the
             card over gloo (K1 on 32 rows of each chunk, 102 launches a
             rank); each against the plain calls (phase_mesh's limits),
             with the combined maps/s of each form
  demos      python -m xfr_torch.demo.whitebox --quick, python -m
             xfr_torch.demo.blackbox (6,500 masks) and its --custom-bb
             (650 masks), at full width, each into a temporary --outdir

Every phase that calls a path twice on the same inputs holds the two
results to the same bits (repeat_diff, check_repeats): one input, one
result, on every run of the card.  Every warm STRise.launch_evaluate
(main's and tf32's through K1, pipeline's and bench's on the
materialized-mask path; refs and gallery already embedded) runs with
every host sync refused: the launch waits for the card nowhere.  One
function runs alone, not by this script: phase_audit (the paths under
torch.use_deterministic_algorithms(True)).

The last lines are the card's name and power limit, the "kernels" line
and {"ok": true, "device": {...}}.
"""

import contextlib
import functools
import gc
import json
import os
import subprocess
import sys
import time
import warnings

import numpy as np

import bench_torch as BT

# NVIDIA H100 SXM data sheet: HBM rate and float32 rate outside the
# tensor cores (the kernels here do plain float32 arithmetic)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
TF32_FLOPS_PER_S = 495e12  # dense, on the tensor cores

N_MASKS, CHUNK, SCALE, ELEMS, SIZE = 6500, 64, 12, 2, 224
MAIN_SEEDS = (1,)  # the main path's timed STRise maps
WB_B, WB_TOPK, WB_TIMED = 8, 32, 2  # bench.py's whitebox mix
# bench.py's eval: 4 maps a probe group, 101 percentiles; 4 timed groups
# (bench_torch.py times bench.py's 10)
EVAL_MAPS, EVAL_GROUPS = 4, 4


_T0 = time.time()


def emit(phase, **rec):
    """One JSON line; ``t_s`` is the seconds since the module was loaded,
    so successive lines give each phase's wall time."""
    print(json.dumps({"phase": phase, **rec, "t_s": time.time() - _T0}),
          flush=True)


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


def repeat_diff(a, b):
    """The largest |a - b| between two results of one call on the same
    inputs (nested dicts, lists and tuples of arrays, tensors, numbers or
    None): 0.0 only when they are the same bit for bit, inf where their
    structure, shape or type differs, the smallest float64 where the
    values are equal and the bits are not (0.0 against -0.0)."""
    import torch

    if isinstance(a, dict) or isinstance(b, dict):
        if not (isinstance(a, dict) and isinstance(b, dict)
                and set(a) == set(b)):
            return float("inf")
        return max((repeat_diff(a[k], b[k]) for k in a), default=0.0)
    if isinstance(a, (list, tuple)) or isinstance(b, (list, tuple)):
        if not (isinstance(a, (list, tuple)) and isinstance(b, (list, tuple))
                and len(a) == len(b)):
            return float("inf")
        return max((repeat_diff(x, y) for x, y in zip(a, b)), default=0.0)
    if a is None or b is None:
        return 0.0 if a is b else float("inf")

    def host(t):
        if isinstance(t, torch.Tensor):
            t = t.detach()
            # bfloat16 widens to float32 exactly
            t = t.float() if t.dtype == torch.bfloat16 else t
            return t.cpu().numpy()
        return np.asarray(t)

    a, b = host(a), host(b)
    if a.shape != b.shape or a.dtype != b.dtype:
        return float("inf")
    if a.tobytes() == b.tobytes():
        return 0.0
    d = float(np.abs(a.astype(np.float64) - b.astype(np.float64)).max())
    return d if d > 0 else float(np.finfo(np.float64).tiny)


def check_repeats(phase, diffs):
    """Raise unless every repeat of ``diffs`` ({name: repeat_diff}) read
    0: one input, one result, on every run of the card."""
    bad = {k: v for k, v in diffs.items() if v != 0.0}
    if bad:
        raise AssertionError(f"{phase}: repeats on the same inputs differ: "
                             f"{bad}")


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    from xfr_torch.utils.device import card_name_and_power_limit

    card = card_name_and_power_limit()
    emit("device", kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), card=card,
         torch=torch.__version__, cuda=torch.version.cuda)
    return card


def phase_build():
    from xfr_torch import kernels

    t0 = time.time()
    names = ("fused_blend", "fused_epilogue")
    for name in names:
        kernels.load(name)
    emit("build", seconds=time.time() - t0,
         libraries=[kernels.library_path(name) for name in names])


def fused_blend_inputs(seed=0, n=CHUNK):
    """Main-path-shaped inputs: a chunk of ``n`` sparse 19x19 grids with 2
    zeros each (64, or 32: a rank's rows of a chunk under a dp=2 mesh),
    shifts in [0, 12), a 0..255 probe and its blur fill."""
    import torch
    from xfr_torch.blackbox import masks as M
    from xfr_torch.models.resnet101 import MEAN_RGB

    g = torch.Generator().manual_seed(seed)  # the masks' draws are the host's
    gh = -(-SIZE // SCALE)
    probs = torch.full((gh, gh), 1.0 / (gh * gh), device="cuda")
    grids = M.sample_sparse_grids(g, probs, n, ELEMS)
    shifts = M.random_shifts(g, n, SCALE, "cuda")
    probe = torch.rand((SIZE, SIZE, 3), generator=g).cuda() * 255
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
    half = kernel_at(CHUNK // 2)
    emit("kernel", max_rel_err=max_rel, rtol=1e-4, atol=1e-3, ok=ok,
         bytes=nbytes, ops=ops, shapes={"grids": [n, gh, gw],
                                        "out": list(out.shape)},
         **{"n%d" % (CHUNK // 2): half}, **rec)
    if not ok or not half["ok"]:
        raise AssertionError("fused_blend kernel disagrees with its plain "
                             f"version: max abs err {max_abs}, at N="
                             f"{CHUNK // 2} {half['max_abs_err']}")
    return rec


def kernel_at(n):
    """K1 against its plain version at ``n`` masks (the rows of a chunk a
    rank launches under the mesh phase's dp=2): error and times."""
    import torch
    from xfr_torch.blackbox import fused_blend as FB

    args = fused_blend_inputs(seed=1, n=n)
    out = FB.fused_mask_blend_preprocess(*args, mask_scale=SCALE)
    ref = FB.fused_mask_blend_preprocess_reference(*args, mask_scale=SCALE)
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    grids, shifts, probe, fill, mean = args
    nbytes = 4 * (grids.numel() + shifts.numel() + probe.numel()
                  + fill.numel() + mean.numel() + out.numel())
    return {"n": n, "max_abs_err": err, "bytes": nbytes,
            "bound_ms": 1e3 * max(nbytes / HBM_BYTES_PER_S,
                                  n * SIZE * SIZE * 28 / F32_FLOPS_PER_S),
            "ok": bool(torch.allclose(out, ref, rtol=1e-4, atol=1e-3)),
            "ms": cuda_ms(lambda: FB.fused_mask_blend_preprocess(
                *args, mask_scale=SCALE)),
            "plain_ms": cuda_ms(
                lambda: FB.fused_mask_blend_preprocess_reference(
                    *args, mask_scale=SCALE)),
            "tol": {"rtol": 1e-4, "atol": 1e-3}}


def epilogue_calls(net, x):
    """The fused epilogues of one keep-limited encode of ``x`` on ``net``
    at "high": {(shape, strides, stages, residual strides): [count, x,
    kwargs of the first such chain]}.  Each chain's inputs come from an
    op-by-op forward that keeps every tensor, a biased convolution's
    output taken again without its bias, as the planned forward takes
    it."""
    import torch
    from xfr_torch import epilogue as EP
    from xfr_torch import ops as O
    from xfr_torch.ebp import interpreter as I
    from xfr_torch.utils.device import precision_scope

    graph, params = net.graph, net.params
    plan = I.clean_plan(graph, params, (net.encode_tensor,), x)
    calls = {}
    with precision_scope("high"), torch.no_grad():
        values = I.forward_values(graph, params, x)
        for kind, chain in plan.steps:
            if kind != "chain":
                continue
            vals = values
            if chain.conv is not None:
                node = graph.nodes[chain.conv]
                vals = list(values)
                vals[chain.x] = O.apply_op(
                    node.op, {"w": params[node.pname]["w"]},
                    tuple(values[i] for i in node.ins), node.attrs_dict)
            cx, kw = EP.chain_args(chain, graph, params, vals)
            stages = tuple(k for k in ("bias", "bn", "gate", "residual")
                           if k in kw) + (("relu",) if kw["relu"] else ())
            r = kw.get("residual")
            key = (tuple(cx.shape), cx.stride(), stages,
                   None if r is None else r.stride())
            calls.setdefault(key, [0, cx, kw])[0] += 1
    return calls


def device_kernels(fn):
    """The kernels the card runs for ``fn()`` (a graph replay's included),
    by torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.name.startswith(("Memcpy", "Memset")))


def epilogue_bytes(x, kw):
    """Bytes one chain needs: x, the residual and the output once, the
    gate and the per-channel vectors once."""
    n = 2 * x.numel()
    if kw.get("residual") is not None:
        n += x.numel()
    if kw.get("gate") is not None:
        n += kw["gate"].numel()
    n += x.shape[1] * ((kw.get("bias") is not None)
                       + 4 * (kw.get("bn") is not None))
    return 4 * n


def epilogue_encode(name, nhwc, rows=CHUNK):
    """One net's 64-row encode: every distinct chain checked and timed,
    and the whole encode captured op by op and planned, timed."""
    import torch
    from xfr_torch import epilogue as EP
    from xfr_torch import replay as R
    from xfr_torch.ebp import interpreter as I
    from xfr_torch.models import create_wbnet
    from xfr_torch.utils.device import precision_scope

    net = create_wbnet(name, device="cuda").net
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((rows, 3, SIZE, SIZE), generator=gen,
                    device="cuda") * 50
    if nhwc:
        x = x.contiguous(memory_format=torch.channels_last)
    chains, total = [], {"count": 0, "ms": 0.0, "plain_ms": 0.0,
                         "bytes": 0}
    for (shape, stride, stages, _), (count, cx, kw) in epilogue_calls(
            net, x).items():
        got = EP.fused_epilogue(cx, **kw)
        want = EP.fused_epilogue_reference(cx, **kw)
        same = bool(torch.equal(got.contiguous().view(torch.int32),
                                want.contiguous().view(torch.int32))
                    and got.stride() == want.stride())
        if not same:
            raise AssertionError(f"epilogue {shape} {stages} differs from "
                                 "its plain version")
        ms = cuda_ms(lambda: EP.fused_epilogue(cx, **kw), reps=7, inner=5)
        plain = cuda_ms(lambda: EP.fused_epilogue_reference(cx, **kw),
                        reps=7, inner=5)
        nbytes = epilogue_bytes(cx, kw)
        chains.append({"shape": list(shape), "stages": list(stages),
                       "count": count, "ms": ms, "plain_ms": plain,
                       "bound_ms": 1e3 * nbytes / HBM_BYTES_PER_S,
                       "roofline_pct": 100 * nbytes / HBM_BYTES_PER_S
                       / (ms / 1e3)})
        total["count"] += count
        total["ms"] += count * ms
        total["plain_ms"] += count * plain
        total["bytes"] += count * nbytes
    total["bound_ms"] = 1e3 * total["bytes"] / HBM_BYTES_PER_S
    total["roofline_pct"] = 100 * total["bound_ms"] / total["ms"]

    enc = net.encode_tensor

    def op_by_op(x):
        with precision_scope("high"):
            return I.forward_values(net.graph, net.params, x,
                                    keep=(enc,))[enc]

    def planned(x):
        with precision_scope("high"):
            return I.forward_clean(net.graph, net.params, x,
                                   keep=(enc,))[enc]

    encode = {}
    for form, fn in (("op_by_op", op_by_op), ("planned", planned)):
        g = R.Captured(fn, x.clone(memory_format=torch.preserve_format))
        encode[form] = {"ms": cuda_ms(g.replay, reps=7, inner=3),
                        "kernels": device_kernels(g.replay),
                        "out": g.replay().clone()}
    same = repeat_diff(encode["op_by_op"].pop("out"),
                       encode["planned"].pop("out"))
    if same != 0.0:
        raise AssertionError(f"{name}: the planned encode differs from the "
                             f"op-by-op encode by {same}")
    return {"net": name, "layout": "nhwc" if nhwc else "nchw", "rows": rows,
            "chains": total["count"], "per_encode": total,
            "encode_ms": {k: v["ms"] for k, v in encode.items()},
            "encode_kernels": {k: v["kernels"] for k, v in encode.items()},
            "largest": sorted(chains, key=lambda c: -c["count"] * c["ms"])[:6]}


def phase_epilogue():
    """The fused epilogue on the main path's encodes (see the module
    docstring); returns its kernel-table record."""
    runs = [epilogue_encode("resnetv6_pytorch", nhwc=False),
            epilogue_encode("resnetv6_pytorch", nhwc=True),
            epilogue_encode("senet50_256", nhwc=True)]
    for r in runs:
        emit("epilogue", **r)
    r101 = runs[0]["per_encode"]
    rec = {"name": "fused_epilogue", "route": "cuda",
           "source": "xfr_torch/csrc/fused_epilogue.cu",
           "replaces": "none: XLA's fusion in xfr_tpu",
           "launches": None,  # a map's, as main_path counts them
           "ms": r101["ms"], "plain_ms": r101["plain_ms"],
           "bound_ms": r101["bound_ms"], "bound_by": "bytes",
           "library_ms": None}
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
    emit("precision", errors=rec, flags_restored=before == after,
         cpu=cpu_precision(x.cpu(), w.cpu(), a.cpu()))
    if before != after or max(rec["high"].values()) > 1e-5:
        raise AssertionError(f"precision_scope: {rec}, {before}->{after}")


def cpu_precision(x, w, a):
    """Whether this host's CPU runs float32 convolutions and products at
    reduced precision (the float32 limits of models_parity and variants
    are 3 times the CPU's own float32 error): the float32 conv and matmul
    of precision's inputs against float64, each timed (median of 5), and
    the oneDNN (mkldnn) settings."""
    import torch
    import torch.nn.functional as F

    def timed(fn):
        fn()
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            out = fn()
            times.append(time.perf_counter() - t0)
        return out, float(np.median(times))

    y32, conv32_s = timed(lambda: F.conv2d(x, w, padding=1))
    y64, conv64_s = timed(lambda: F.conv2d(x.double(), w.double(), padding=1))
    m32, mm32_s = timed(lambda: a @ a)
    m64, mm64_s = timed(lambda: a.double() @ a.double())
    mk = torch.backends.mkldnn
    return {
        "conv_rel_err": float((y32.double() - y64).abs().max()
                              / y64.abs().max()),
        "matmul_rel_err": float((m32.double() - m64).abs().max()
                                / m64.abs().max()),
        "conv_s": {"float32": conv32_s, "float64": conv64_s},
        "matmul_s": {"float32": mm32_s, "float64": mm64_s},
        "mkldnn": {"available": mk.is_available(), "enabled": mk.enabled,
                   "deterministic": mk.deterministic,
                   "fp32_precision": {
                       k: getattr(getattr(mk, k, None), "fp32_precision",
                                  None) for k in ("conv", "matmul")}},
        "float32_matmul_precision": torch.get_float32_matmul_precision(),
        "cpu_capability": torch.backends.cpu.get_cpu_capability(),
        "threads": torch.get_num_threads()}


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


def make_main_path_strise(net_dict, seed, num_masks=N_MASKS, **kw):
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
                  blur_fill_sigma_percent=4, num_masks=num_masks, seed=seed,
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
    from xfr_torch import epilogue as EP
    from xfr_torch.blackbox import fused_blend as FB
    from xfr_torch.ebp import interpreter as I

    t0 = time.time()
    wb, net_dict = main_path_net()
    emit("net", seconds=time.time() - t0, nodes=len(wb.net.graph.nodes),
         events=wb.net.graph.n_events)
    make = functools.partial(make_main_path_strise, net_dict)

    fused = dict(use_pallas_blend=True, score_precision="high")
    # warm-up at 10 chunks: the same kernels, refs and gallery embedded
    check_map(make(0, num_masks=10 * CHUNK, **fused).launch_evaluate()())
    torch.cuda.synchronize()
    per_map = -(-N_MASKS // CHUNK)
    # the fused epilogues of one encode: each chunk's captured encode
    # replays them, and the probe's own encode (64 rows, eager) runs them
    enc = wb.net.encode_tensor
    chains = sum(kind == "chain" for kind, _ in I.clean_plan(
        wb.net.graph, wb.net.params, (enc,),
        torch.empty(0, device="cuda")).steps)
    ep_per_map = (per_map + 1) * chains

    # --- the main path: counts at 0, the timed maps, counts read after ---
    torch.cuda.reset_peak_memory_stats()
    FB.fused_mask_blend_preprocess.launches = 0
    EP.fused_epilogue.launches = 0
    times, deltas, ep_deltas, kept = [], [], [], None
    for seed in MAIN_SEEDS:
        c0 = FB.fused_mask_blend_preprocess.launches
        e0 = EP.fused_epilogue.launches
        t0 = time.time()
        st = make(seed, **fused)
        with host_syncs_refused(True):
            finish = st.launch_evaluate()
        smap = finish()
        torch.cuda.synchronize()
        times.append(time.time() - t0)
        deltas.append(FB.fused_mask_blend_preprocess.launches - c0)
        ep_deltas.append(EP.fused_epilogue.launches - e0)
        check_map(smap)
        if kept is None:
            kept = st
    launches = FB.fused_mask_blend_preprocess.launches
    peak = torch.cuda.max_memory_allocated()
    emit("main", maps=len(MAIN_SEEDS), map_s=times,
         maps_per_s=len(MAIN_SEEDS) / sum(times),
         launches=launches, launches_per_map=deltas, expected=per_map,
         epilogue_launches_per_map=ep_deltas,
         epilogue_expected=ep_per_map, peak_mem_bytes=peak,
         score_precision="high", launch_with_host_syncs_refused=True)
    if deltas != [per_map] * len(MAIN_SEEDS):
        raise AssertionError(f"fused_blend launched {deltas} times per "
                             f"map, expected {per_map}")
    if ep_deltas != [ep_per_map] * len(MAIN_SEEDS):
        raise AssertionError(f"fused_epilogue ran {ep_deltas} times per "
                             f"map, expected {ep_per_map}")
    return wb, make, kept, launches, times[0], ep_deltas[0]


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
    uniform = uniform_draws_card_vs_cpu()
    if not same_masks or ds.max() > 1e-6 or dmap > map_atol:
        raise AssertionError("kernel and materialized branches disagree")
    check_repeats("branches: uniform-prior masks, card against CPU", uniform)


def uniform_draws_card_vs_cpu(seeds=(0, 1), materialized=640):
    """STRise(seed=s, prior_type="uniform")'s masks on the card and on the
    CPU (scale 12, 2 elements): the grids and shifts of the fused-blend
    path at the main path's 6,500 masks, and the first ``materialized``
    masks of the materialized-mask path (the CPU's upsampling of all
    6,500 would take seconds), each card against CPU by repeat_diff (the
    draws and the uniform prior's grid are the host's, so they must read
    0).  Emits the readings; returns them."""
    from xfr_torch.blackbox.strise import STRise

    probe, ref, gal = _images(7, 3)
    out = {}
    for seed in seeds:
        got = {}
        for dev in ("cuda", "cpu"):
            kw = dict(probe=probe, refs=[ref], gallery=[gal],
                      black_box_fn=lambda p, g: np.zeros((len(p), len(g))),
                      prior_type="uniform", mask_scale=SCALE,
                      num_mask_elements=ELEMS, seed=seed, device=dev)
            st = STRise(use_pallas_blend=True, num_masks=N_MASKS, **kw)
            st.uniform_prior()
            st.generate_masks()
            st_m = STRise(use_pallas_blend=False, num_masks=materialized,
                          **kw)
            st_m.uniform_prior()
            st_m.generate_masks()
            got[dev] = {"grids": st._grids_dev, "shifts": st._shifts_dev,
                        "masks": st_m._masks_dev}
        for k in got["cpu"]:
            out["seed%d_%s" % (seed, k)] = repeat_diff(got["cuda"][k],
                                                       got["cpu"][k])
    emit("uniform_draws", masks=N_MASKS, materialized=materialized,
         card_vs_cpu=out)
    return out


def phase_tf32(make, st_high):
    """Seed 1's map with TF32 allowed in the scoring encode, a warm-up and
    a timed map, the same bit for bit, compared with the full-float32 map
    of the same seed."""
    import torch

    kw = dict(use_pallas_blend=True, score_precision=None)
    warm = make(1, **kw)  # warm-up, repeated by the timed map
    check_map(warm.launch_evaluate()())
    t0 = time.time()
    first = make(1, **kw)
    with host_syncs_refused(True):
        finish = first.launch_evaluate()
    check_map(finish())
    torch.cuda.synchronize()
    times = [time.time() - t0]
    repeat = {"map": repeat_diff(first.saliency_map, warm.saliency_map),
              "scores": repeat_diff(first.mask_scores, warm.mask_scores)}
    sel_h, sel_t = st_high.mask_scores > 0, first.mask_scores > 0
    emit("tf32", map_s=times, maps_per_s=len(times) / sum(times),
         score_precision=None, repeat_of_warmup=repeat,
         launch_with_host_syncs_refused=True,
         vs_high={"map_corr": float(np.corrcoef(
             first.saliency_map.ravel(), st_high.saliency_map.ravel())[0, 1]),
             "score_max_abs_diff": float(np.abs(
                 first.mask_scores - st_high.mask_scores).max()),
             "selection_disagree": int((sel_h != sel_t).sum()),
             "selected_high": int(sel_h.sum())})
    check_repeats("tf32", repeat)


def phase_breakdown(wb, make, kernel_ms, st_k):
    """One map step by step, each step ended by a synchronize, plus one
    scoring chunk's encode by CUDA events.  The map is seed 1's, the
    main path's first timed map ``st_k`` again: its prior, masks, scores
    and map must be the same bit for bit.  The draw of its masks (the
    host's noise and shifts and their uploads) runs once more with every
    host sync refused."""
    import torch
    from xfr_torch.blackbox import masks as M
    from xfr_torch.blackbox.strise import _encode_and_score
    from xfr_torch.utils.device import precision_scope

    st = make(1, use_pallas_blend=True, score_precision="high")
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
    # the host draw and its pinned uploads wait for nothing
    gen = torch.Generator().manual_seed(1)
    probs = M.prior_to_grid(st.prior, SCALE, st.prior_type)
    torch.cuda.synchronize()
    with host_syncs_refused(True):
        M.sample_sparse_grids(gen, probs, N_MASKS, ELEMS)
        M.random_shifts(gen, N_MASKS, SCALE, "cuda")
    repeat = {"prior": repeat_diff(st.prior, st_k.prior),
              "grids": repeat_diff(st._grids_dev, st_k._grids_dev),
              "shifts": repeat_diff(st._shifts_dev, st_k._shifts_dev),
              "scores": repeat_diff(st.mask_scores, st_k.mask_scores),
              "map": repeat_diff(st.saliency_map, st_k.saliency_map)}

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
         fused_blend_per_map_s=kernel_ms * per_map / 1e3,
         repeat_of_main_seed1=repeat, draw_with_host_syncs_refused=True)
    check_repeats("breakdown", repeat)


def phase_pipeline(wb, make, main_s):
    """What STRise's materialized-mask map (bench.py's path) costs beside
    main's K1 map (PERF.md §7).  Seed 1 at "high", launched with every
    host sync refused, and finished.  ``main_s``: main's seed-1 map
    seconds (K1, "high").  Then one scoring chunk's encode at "high" by
    CUDA events on the blends as each path hands them over: the
    materialized path's preprocess permutes an [N,H,W,3] blend (NHWC
    memory viewed as NCHW), K1 writes NCHW."""
    import torch
    from xfr_torch.blackbox.strise import _encode_and_score
    from xfr_torch.utils.device import precision_scope

    st = make(1, score_precision="high")
    torch.cuda.synchronize()
    t0 = time.time()
    with host_syncs_refused(True):
        finish = st.launch_evaluate()
    check_map(finish())
    map_s = time.time() - t0

    blend = torch.rand((CHUNK, SIZE, SIZE, 3), device="cuda") * 255
    layouts = {"nhwc_view": blend.permute(0, 3, 1, 2),
               "nchw": blend.permute(0, 3, 1, 2).contiguous()}
    e = torch.randn((2, 512), device="cuda")
    net = wb.net
    with precision_scope("high"):
        enc_ms = {k: cuda_ms(lambda x=x: _encode_and_score(
            net.graph, net.encode_tensor, net.params, x, e, e),
            reps=5, inner=2, warmup=1) for k, x in layouts.items()}
    per_map = -(-N_MASKS // CHUNK)
    emit("pipeline", score_precision="high", path="materialized masks",
         map_s=map_s, main_k1_map_s=main_s,
         launch_with_host_syncs_refused=True, encode_chunk_ms=enc_ms,
         encode_per_map_s={k: v * per_map / 1e3 for k, v in enc_ms.items()})


@contextlib.contextmanager
def warm_launches_held():
    """Every STRise.launch_evaluate in the block runs with every host sync
    refused, but the first on each refs list (it embeds the refs and the
    gallery, and fetches them to the host, as a cold launch must).
    Yields the counts {"cold", "held"}."""
    from xfr_torch.blackbox.strise import STRise

    launch = STRise.launch_evaluate
    seen, counts = [], {"cold": 0, "held": 0}

    def held(self, *a, **kw):
        if not any(r is self.refs for r in seen):
            seen.append(self.refs)
            counts["cold"] += 1
            return launch(self, *a, **kw)
        with host_syncs_refused(True):
            out = launch(self, *a, **kw)
        counts["held"] += 1
        return out

    STRise.launch_evaluate = held
    try:
        yield counts
    finally:
        STRise.launch_evaluate = launch


BENCH_COUNTS = dict(wb_iters=2, bb_maps=2, bb_high_maps=2, eval_groups=3)


def phase_bench(wb):
    """bench_torch.run through its real code on ``wb`` (full
    ResNet-101+L2, bfloat16 sweep) at BENCH_COUNTS, with its exact
    checks; bench_torch prints its five lines.  Every STRise launch but
    the warm-up of each function runs with every host sync refused; K1
    must launch 0 times (bench.py keeps it off)."""
    from xfr_torch.utils.device import card_name_and_power_limit

    card = card_name_and_power_limit()
    k1_0 = k1_launches()
    with warm_launches_held() as counts:
        recs = BT.run(wb, card, **BENCH_COUNTS)
    k1 = k1_launches() - k1_0
    wb.net.reset_classifier()
    # each function: maps 1..n and the rerun of seed 0 after the warm-up
    held = BENCH_COUNTS["bb_maps"] + BENCH_COUNTS["bb_high_maps"] + 2
    emit("bench", counts=BENCH_COUNTS, lines=len(recs), launches=counts,
         k1_launches=k1)
    check_no_k1("bench", k1)
    if counts != {"cold": 2, "held": held}:
        raise AssertionError(f"bench: STRise launches {counts}, expected "
                             f"2 cold and {held} held")


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
    w_cpu = BT.whitebox_workload(wbs["cpu"], np.random.RandomState(1), B=2)
    ws = {"cpu": w_cpu, "cuda": {k: v.cuda() for k, v in w_cpu.items()}}
    out, secs = {}, {}
    for dev in ("cuda", "cpu", "cuda"):  # the first card mix warms up
        t0 = time.time()
        out[dev] = BT.drain_mix(wbs[dev], BT.launch_mix(wbs[dev], ws[dev]))
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


def run_mix(wb, w, mode="norelu", shape=(112, 112), profile=True):
    """The mix as bench.py runs it: one warm-up mix with host syncs refused
    during the launches, then WB_TIMED mixes launched and drained
    double-buffered; then one mix alone, and (``profile``) its stages by
    CUDA events.  Every mix runs the same inputs: each method's maps and
    the selected subtrees of every timed and the lone mix must equal the
    warm-up's bit for bit (``repeat_max_abs_diff``, raised on).  Returns
    the record."""
    import torch

    B = w["probes"].shape[0]
    t0 = time.time()
    k1_0 = k1_launches()
    with host_syncs_refused(True):
        launched = BT.launch_mix(wb, w, mode=mode)
    out = BT.drain_mix(wb, launched)
    torch.cuda.synchronize()
    warm_s = time.time() - t0
    check_wb_maps(out, shape)

    # the peak is this mix's: nets of earlier phases held in reference
    # cycles are freed first
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    start_mem = torch.cuda.memory_allocated()
    times, launch_s, drain_s, drained = [], [], [], []
    t0 = time.time()
    tl = time.time()
    prev = BT.launch_mix(wb, w, mode=mode)
    launch_s.append(time.time() - tl)
    for _ in range(WB_TIMED - 1):
        tl = time.time()
        st = BT.launch_mix(wb, w, mode=mode)
        launch_s.append(time.time() - tl)
        td = time.time()
        drained.append(BT.drain_mix(wb, prev))
        check_wb_maps(drained[-1], shape)
        drain_s.append(time.time() - td)
        t1 = time.time()
        times.append(t1 - t0)
        t0, prev = t1, st
    td = time.time()
    last = BT.drain_mix(wb, prev)
    check_wb_maps(last, shape)
    drain_s.append(time.time() - td)
    times.append(time.time() - t0)
    peak = torch.cuda.max_memory_allocated()

    # one mix alone: the launch call against the whole mix
    torch.cuda.synchronize()
    t0 = time.time()
    st = BT.launch_mix(wb, w, mode=mode)
    one_launch = time.time() - t0
    lone = BT.drain_mix(wb, st)
    one_mix = time.time() - t0
    repeats = {name: max(repeat_diff(o[name], out[name])
                         for o in drained + [last, lone]) for name in out}

    rec = {}
    if profile:
        rec["stage_event_ms"] = stage_event_ms(wb, w, mode)
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
               k1_launches=k1, repeat_max_abs_diff=repeats)
    check_no_k1("whitebox mix", k1)
    check_repeats("whitebox mix", repeats)
    return rec


def phase_whitebox():
    """bench.py's whitebox mix on full ResNet-101+L2: B=8, bfloat16 sweep,
    one warm-up mix with host syncs refused during the launches, then
    WB_TIMED mixes launched and drained double-buffered."""
    import torch

    wb = whitebox_net("cuda")
    wb.wsebp_dtype = torch.bfloat16
    w = BT.whitebox_workload(wb, np.random.RandomState(0), WB_B)
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


def eval_group_profile(wb, w):
    """One eval group launched and drained under torch.profiler, which
    records the program's spans and counters.  Returns (summary, kernel
    rows): the group's wall time, device busy time (every kernel and
    copy; one stream), idle share, device time by kernel group and of the
    blend's kernels (span ``xfr.eval.blend``), the blend+encode steps and
    rows encoded (counters ``xfr.eval.steps``, ``xfr.eval.rows_encoded``),
    and the (device us, launches, kernel name) rows."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from tools.torch_strise_profile import group_of
    from xfr_torch.utils.profiling import counters

    torch.cuda.synchronize()
    before = counters()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        BT.drain_eval_group(BT.launch_eval_group(wb, w, 0))
        torch.cuda.synchronize()
        wall = time.time() - t0
    count = {k: counters().get(k, 0) - before.get(k, 0)
             for k in ("xfr.eval.steps", "xfr.eval.rows_encoded")}
    rows, blend = [], None
    for e in prof.key_averages():
        if e.key.startswith("xfr."):
            # a span's CUDA row is its extent on the device's timeline,
            # not a kernel: only the blend's CPU row's kernel time is kept
            if e.key == "xfr.eval.blend" and \
                    e.device_type == DeviceType.CPU:
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
             "blend": blend, "steps": count["xfr.eval.steps"],
             "rows": count["xfr.eval.rows_encoded"],
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
    w = BT.eval_workload(wbs["cpu"], np.random.RandomState(1),
                         percentiles=pct)
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
    then one group alone, its steps and rows, and one profiled group.
    The groups alternate bench.py's two pairs: every group's
    classifications and distances must equal those of the first group of
    its pair bit for bit."""
    import torch
    from xfr_torch.blackbox import fused_blend as FB

    t0 = time.time()
    wb = whitebox_net("cuda")
    w = BT.eval_workload(wb, np.random.RandomState(0))
    k1_before = FB.fused_mask_blend_preprocess.launches
    # the first result of each pair: every later group of the pair must
    # give the same classifications and distances bit for bit
    with host_syncs_refused(True):
        launched = BT.launch_eval_group(wb, w, 0)
    seen = {0: BT.drain_eval_group(launched)}
    torch.cuda.synchronize()
    warm_s = time.time() - t0
    wb._upload_memo.clear()  # the first timed group pays its upload again
    repeat = []

    def check(p, out):
        if p % 2 in seen:
            repeat.append(repeat_diff(out, seen[p % 2]))
        else:
            seen[p % 2] = out

    torch.cuda.reset_peak_memory_stats()
    times, launch_s, iou_s = [], [], []

    def launch(p):
        tl = time.time()
        g = BT.launch_eval_group(wb, w, p)
        launch_s.append(time.time() - tl)
        iou_s.append(g[2])
        return g

    t0 = time.time()
    pend = launch(0)
    for p in range(1, EVAL_GROUPS):
        nxt = launch(p)
        check(p - 1, BT.drain_eval_group(pend))
        t1 = time.time()
        times.append(t1 - t0)
        t0, pend = t1, nxt
    check(EVAL_GROUPS - 1, BT.drain_eval_group(pend))
    times.append(time.time() - t0)
    peak = torch.cuda.max_memory_allocated()

    torch.cuda.synchronize()
    t0 = time.time()
    g = BT.launch_eval_group(wb, w, 1)
    one_launch = time.time() - t0
    check(1, BT.drain_eval_group(g))
    one_group = time.time() - t0
    prof, _ = eval_group_profile(wb, w)
    k1 = FB.fused_mask_blend_preprocess.launches - k1_before
    T = len(w["kw"]["percentiles"])
    emit("eval", groups=EVAL_GROUPS, evals_per_group=EVAL_MAPS,
         interval_s=times, evals_per_s=EVAL_MAPS * EVAL_GROUPS / sum(times),
         warmup_s=warm_s, peak_mem_bytes=peak, launch_s=launch_s,
         host_iou_s=iou_s, one_group={"launch_s": one_launch,
                                      "group_s": one_group},
         steps_per_group=prof["steps"], rows_per_group=prof["rows"],
         rows_used=EVAL_MAPS * T, profile=prof, k1_launches=k1,
         encode_precision="TF32 allowed",
         repeat_max_abs_diff=max(repeat), repeats=len(repeat))
    check_repeats("eval", {"groups": max(repeat)})
    if k1 != 0:
        raise AssertionError(f"the eval path launched K1 {k1} times")
    if prof["rows"] != prof["steps"] * wb.blend_batch:
        raise AssertionError(f"eval steps {prof['steps']}, rows "
                             f"{prof['rows']}")


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
    maps within 1e-6 of their max).  The card runs every path twice, and
    the two runs must be the same bit for bit."""
    import torch

    wbs = {dev: whitebox_net(dev, layers=(1, 1, 1, 1))
           for dev in ("cpu", "cuda")}
    w = BT.whitebox_workload(wbs["cpu"], np.random.RandomState(3), B=1)
    for dev, wb in wbs.items():
        wb.net.set_triplet_classifier(w["em"].to(dev), w["en"].to(dev))
    res, secs = {}, {}
    repeats = {}
    for dev in ("cuda", "cpu", "cuda"):  # the first card pass warms up
        for name, kw in WSEBP_PATHS.items():
            t0 = time.time()
            first = res.get((dev, name))
            res[dev, name] = wbs[dev].weighted_subtree_ebp(
                w["probes"].to(dev), 0, 1, topk=WB_TOPK,
                subtree_mode="norelu", **kw)
            if dev == "cuda":
                torch.cuda.synchronize()
            secs[dev, name] = time.time() - t0
            if first is not None:
                repeats[name] = repeat_diff(res[dev, name], first)
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
              "batched_map_err_rel_to_max": 1e-6},
         card_repeat_max_abs_diff=repeats)
    check_repeats("wsebp_parity", repeats)
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
    written, by_key = [], {}
    save = npz_writer(tmp.name, written)

    def write(job, key, smap):
        t = time.time()
        save(job, key, smap)
        by_key[job["label"], key] = written[-1]
        host["write_s"] += time.time() - t

    # one warm-up group, every host sync refused during its launch: the
    # first group of the batched run below, whose maps must be the same
    t0 = time.time()
    group = [resolve(j) for j in generation_jobs(GEN_B)]
    with host_syncs_refused(True):
        st = G.launch_wb_group(wb, group, GEN_B, mode, 6)
    G.drain_wb_group(wb, st, write)
    torch.cuda.synchronize()
    warm_s = time.time() - t0
    warm_maps, by_key = by_key, {}

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
    repeats = {"batched_first_group": repeat_diff(
        warm_maps, {k: by_key[k] for k in warm_maps})}

    # one probe through the serial method functions
    probe, mates, nonmates = generation_jobs(1, seed=200)[0]["images"]
    serial = {}

    def timed(name, fn):
        """The method twice: its first call, then a timed call with its
        peak memory; the two maps must be the same bit for bit."""
        t = time.time()
        m0 = fn()
        torch.cuda.synchronize()
        first = time.time() - t
        torch.cuda.reset_peak_memory_stats()
        t = time.time()
        m = fn()
        torch.cuda.synchronize()
        serial[name] = {"first_s": first, "s": time.time() - t,
                        "peak_mem_bytes": torch.cuda.max_memory_allocated()}
        check_wb_maps({"weighted_subtree": [m]})
        repeats["serial " + name] = repeat_diff(m, m0)

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
         k1_launches=k1, repeat_max_abs_diff=repeats)
    check_repeats("generate", repeats)
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

    w = BT.eval_workload(wb, np.random.RandomState(0), chw=chw)
    with host_syncs_refused(True):
        launched = BT.launch_eval_group(wb, w, 0)
    BT.drain_eval_group(launched)
    torch.cuda.synchronize()
    wb._upload_memo.clear()
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    g = BT.launch_eval_group(wb, w, 1)
    launch_s = time.time() - t0
    BT.drain_eval_group(g)
    group_s = time.time() - t0
    return {"maps": EVAL_MAPS, "percentiles": len(BT.PERCENTILES),
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
    mix = run_mix(wb, BT.whitebox_workload(wb, np.random.RandomState(0),
                                            WB_B),
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
    timed, the two results the same bit for bit (top 1 after top 8, whose
    rank walk it shares, runs once), every map non-zero; at one
    block a stage the same calls at event 37 (a BatchNorm there) plus
    subtree_ebp(mode="percentile") on
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
    full, repeats = {}, {}
    calls = variant_calls(wb, xc, k_full, k_el)
    # subtree_ebp at top 1 reuses top 8's rank walk, warm: it runs once
    top1 = "subtree_percentile_argmax_top1"
    calls[top1] = calls.pop(top1)
    for name, call in calls.items():
        first = None
        if name != top1:
            first = call()
            torch.cuda.synchronize()
        t0 = time.time()
        res = call()
        m, sel = _variant_map(res)
        full[name] = {"s": time.time() - t0, "max": float(m.max())}
        if sel is not None:
            full[name]["subtrees"] = sel[0]
        if first is not None:
            repeats[name] = repeat_diff(res, first)
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
         k1_launches=k1_launches() - k1_0, repeat_max_abs_diff=repeats)
    check_no_k1("variants", k1_launches() - k1_0)
    check_repeats("variants", repeats)
    if not ok:
        raise AssertionError(f"variants: card and CPU disagree: {reduced}, "
                             f"uint8 prior {prior_err} of {pmax}")


# the detector's phases: a synthetic 600x800 image at the default scale
# (blob 800x1067, res4 50x67, 30,150 anchors)
DET_HW = (600, 800)
DET_REL = 1e-4      # card against CPU, of each output's max
DET_MARGIN = 1e-4   # final scores compared where separated by this
DET_BOX_PX = 0.1    # final boxes, pixels


def detect_image(seed=0):
    """A synthetic 600x800 uint8 RGB image: noise with bright and dark
    rectangles."""
    rng = np.random.RandomState(seed)
    H, W = DET_HW
    img = (rng.rand(H, W, 3) * 80 + 60).astype(np.uint8)
    for _ in range(6):
        h, w = rng.randint(H // 15, H // 4, 2)
        y, x = rng.randint(0, H - h), rng.randint(0, W - w)
        img[y:y + h, x:x + w] = rng.randint(0, 256, 3)
    return img


@contextlib.contextmanager
def detector_precision(precision):
    """The detector's convolution precision swapped for a block."""
    from xfr_torch.detection import network as DN

    prev, DN._PRECISION = DN._PRECISION, precision
    try:
        yield
    finally:
        DN._PRECISION = prev


def _unit_scale(graph, params, x):
    """One forward of ``graph`` on ``x`` that rescales each conv and
    linear, in call order, so that its output has unit standard deviation
    (in place on ``params``); returns the values."""
    from xfr_torch import ops as O

    values = [None] * graph.n_tensors
    values[graph.input_id] = x
    for node in graph.nodes:
        p = params.get(node.pname, {}) if node.pname else {}
        y = O.apply_op(node.op, p, tuple(values[i] for i in node.ins),
                       node.attrs_dict)
        if node.op in ("conv2d", "linear"):
            s = y.std()
            for v in p.values():
                v.div_(s)
            y = y / s
        values[node.out] = y
    return values


def detector_params(seed=0):
    """The detector's random weights on the card: the numpy init (seeds
    seed, seed+1, seed+2, as FasterRCNNNetwork draws them), each conv and
    linear then rescaled in call order to unit output deviation on one
    seeded 224x224 image (the top on that image's RoIs).  Unscaled, the
    init's activations grow through the residual blocks until res4
    reaches ~2e11, every RPN delta moves its box off the image, and the
    proposal layer keeps no RoI (phase_detect reports it)."""
    import torch

    from xfr_torch import ops as O
    from xfr_torch.detection import boxes as B
    from xfr_torch.detection import detector as D
    from xfr_torch.detection.network import FasterRCNNNetwork
    from xfr_torch.utils.device import precision_scope

    net = FasterRCNNNetwork(seed=seed)
    img = (np.random.RandomState(seed + 10).rand(224, 224, 3) * 255).astype(
        np.uint8)
    blob, scales = D._get_image_blob(img, (224,), 1300)
    im_info = np.array([[224, 224, scales[0]]], np.float32)
    x = net._to_device(blob)
    with torch.no_grad(), precision_scope("high"):
        tg, rg = net.trunk_graph, net.rpn_graph
        feats = _unit_scale(tg, net.params["trunk"], x)[tg.output_id]
        relu = _unit_scale(rg, net.params["rpn"], feats)[net._rpn_relu]
        node = net._rpn_bbox_node
        p = net.params["rpn"][node.pname]
        s = O.apply_op(node.op, p, (relu,), node.attrs_dict).std()
        for v in p.values():
            v.div_(s)
        _, prob, bbox = net._features_and_rpn(x)
        rois = B.proposal_layer(prob.cpu().numpy(), bbox.cpu().numpy(),
                                im_info)
        roi_feats = B.roi_pool(feats.cpu().numpy(), rois, (14, 14), 0.0625)
        _unit_scale(net.top_graph, net.params["top"],
                    net._to_device(roi_feats))
    return net.params


def _rel(a, b):
    return float(np.abs(a.astype(np.float64) - b).max() / np.abs(b).max())


def check_dets(dets):
    if not (dets.ndim == 2 and dets.shape[1] == 5 and
            np.isfinite(dets).all() and (dets[:, 2] > 0).all() and
            (dets[:, 3] > 0).all()):
        raise AssertionError(f"detections {dets.shape}: not [n, 5] finite "
                             "with positive widths and heights")


def compare_dets(got, want):
    """Each of ``want``'s detections whose score lies more than DET_MARGIN
    from every other score of its set must have a detection in ``got``
    within DET_MARGIN / 2 of its score and DET_BOX_PX of its box.
    Returns (separated, matched, not separated)."""
    sep = matched = 0
    for i, d in enumerate(want):
        gaps = np.abs(np.delete(want[:, 4], i) - d[4])
        if len(gaps) and gaps.min() <= DET_MARGIN:
            continue
        sep += 1
        near = got[np.abs(got[:, 4] - d[4]) <= DET_MARGIN / 2]
        if len(near) and np.abs(near[:, :4] - d[:4]).max(axis=1).min() <= \
                DET_BOX_PX:
            matched += 1
    return sep, matched, len(want) - sep


def phase_detect_parity():
    """The detector's network on the card and on the CPU, same weights
    (``detector_params``), on the synthetic image at the default 800 px:
    the trunk's features, the RPN's probabilities and deltas; the top on
    the CPU's RoIs on both devices; then both devices' detect()."""
    from xfr_torch.detection import boxes as B
    from xfr_torch.detection import detector as D
    from xfr_torch.detection.network import FasterRCNNNetwork
    from xfr_torch.models.common import params_to

    img = detect_image()
    blob, scales = D._get_image_blob(img)
    im_info = np.array([[blob.shape[2], blob.shape[3], scales[0]]],
                       np.float32)
    params = detector_params()
    nets = {"cuda": FasterRCNNNetwork(params=params),
            "cpu": FasterRCNNNetwork(params={
                part: params_to(p, "cpu") for part, p in params.items()},
                device="cpu")}
    k1_0 = k1_launches()
    rpn = {dev: [t.cpu().numpy() for t in net._features_and_rpn(
        net._to_device(blob))] for dev, net in nets.items()}
    names = ("feats", "rpn_prob", "rpn_bbox")
    errs = {n: _rel(rpn["cuda"][i], rpn["cpu"][i])
            for i, n in enumerate(names)}
    feats, prob, bbox = rpn["cpu"]
    rois = B.proposal_layer(prob, bbox, im_info)
    roi_feats = B.roi_pool(feats, rois, (14, 14), 0.0625)
    top = {dev: [t.cpu().numpy() for t in net._top(net._to_device(
        roi_feats))] for dev, net in nets.items()}
    errs["bbox_pred"] = _rel(top["cuda"][0], top["cpu"][0])
    errs["cls_prob"] = _rel(top["cuda"][1], top["cpu"][1])
    dets = {dev: D.FasterRCNN(net=net, conf_threshold=-1.0).detect(img)
            for dev, net in nets.items()}
    for d in dets.values():
        check_dets(d)
    sep, matched, tied = compare_dets(dets["cuda"], dets["cpu"])
    k1 = k1_launches() - k1_0
    emit("detect_parity", blob=list(blob.shape), res4=list(feats.shape),
         anchors=int(prob.shape[2] * prob.shape[3] * 9), rois=len(rois),
         rel_err=errs, tol={"rel": DET_REL, "score_margin": DET_MARGIN,
                            "box_px": DET_BOX_PX},
         detections={dev: len(d) for dev, d in dets.items()},
         separated=sep, matched=matched, not_separated=tied,
         k1_launches=k1)
    check_no_k1("detect_parity", k1)
    bad = {k: v for k, v in errs.items() if not v <= DET_REL}
    if bad or matched != sep or sep == 0:
        raise AssertionError(f"detect_parity: card and CPU disagree: {bad}, "
                             f"{matched} of {sep} separated detections "
                             "matched")


def detect_stages(net, img, reps=1):
    """One detect() pass split into its stages, each the median of
    ``reps``: the blob on the host, the upload, trunk+RPN and the top by
    CUDA events, the device->host copies, the proposal layer and roi_pool
    on the host, and the RoI features' host->device copy."""
    import torch

    from xfr_torch.detection import boxes as B
    from xfr_torch.detection import detector as D

    rec = {k: [] for k in ("blob_s", "upload_s", "trunk_rpn_ms", "d2h_s",
                           "proposal_s", "roi_pool_s", "h2d_s", "top_ms")}
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t = time.perf_counter()
        blob, scales = D._get_image_blob(img)
        im_info = np.array([[blob.shape[2], blob.shape[3], scales[0]]],
                           np.float32)
        rec["blob_s"].append(time.perf_counter() - t)
        t = time.perf_counter()
        im = net._to_device(blob)
        torch.cuda.synchronize()
        rec["upload_s"].append(time.perf_counter() - t)
        a.record()
        feats, prob, bbox = net._features_and_rpn(im)
        b.record()
        b.synchronize()
        rec["trunk_rpn_ms"].append(a.elapsed_time(b))
        t = time.perf_counter()
        prob, bbox, feats = (x.cpu().numpy() for x in (prob, bbox, feats))
        rec["d2h_s"].append(time.perf_counter() - t)
        t = time.perf_counter()
        rois = B.proposal_layer(prob, bbox, im_info)
        rec["proposal_s"].append(time.perf_counter() - t)
        t = time.perf_counter()
        roi_feats = B.roi_pool(feats, rois, (14, 14), 0.0625)
        rec["roi_pool_s"].append(time.perf_counter() - t)
        t = time.perf_counter()
        roi_dev = net._to_device(roi_feats)
        torch.cuda.synchronize()
        rec["h2d_s"].append(time.perf_counter() - t)
        a.record()
        net._top(roi_dev)
        b.record()
        b.synchronize()
        rec["top_ms"].append(a.elapsed_time(b))
    out = {k: float(np.median(v)) for k, v in rec.items()}
    out.update(rois=len(rois), d2h_bytes=feats.nbytes + prob.nbytes +
               bbox.nbytes, h2d_bytes=roi_feats.nbytes)
    return out


def phase_detect():
    """FasterRCNN(conf_threshold=-1.0) at full width on the card (default
    800 px, max 1300) with ``detector_params``: one warm-up, 1 timed
    detect() call (its detections the warm-up's bit for bit), one with
    rotate_flags=7 and padding 10; the stages of
    one pass, full float32 and TF32; peak memory; K1 launches (0).  Also
    the unscaled numpy init's res4 magnitude and RoI count."""
    import torch

    from xfr_torch.detection import FasterRCNN

    from xfr_torch.detection import boxes as B
    from xfr_torch.detection import detector as D

    img = detect_image()
    k1_0 = k1_launches()
    gc.collect()
    # the unscaled numpy init, for the record: its res4 and RoI count
    raw = FasterRCNN(conf_threshold=-1.0).net
    blob, scales = D._get_image_blob(img)
    feats, prob, bbox = raw._features_and_rpn(raw._to_device(blob))
    raw_rec = {"res4_absmax": float(feats.abs().max()),
               "rpn_bbox_absmax": float(bbox.abs().max()),
               "rois": len(B.proposal_layer(
                   prob.cpu().numpy(), bbox.cpu().numpy(),
                   [[blob.shape[2], blob.shape[3], scales[0]]]))}
    del raw, feats, prob, bbox
    t0 = time.time()
    det = FasterRCNN(conf_threshold=-1.0, params=detector_params())
    build_s = time.time() - t0
    t0 = time.time()
    warm = det.detect(img)
    check_dets(warm)
    warm_s = time.time() - t0
    torch.cuda.reset_peak_memory_stats()
    start_mem = torch.cuda.memory_allocated()
    last = {}

    def timed(n, **kw):
        walls = []
        for _ in range(n):
            t = time.perf_counter()
            dets = det.detect(img, **kw)
            walls.append(time.perf_counter() - t)
            check_dets(dets)
        last["dets"] = dets
        return walls, len(dets)

    walls, n_dets = timed(1)
    repeat = {"detections": repeat_diff(last["dets"], warm)}
    peak = torch.cuda.max_memory_allocated()
    det.rotate_flags = 7
    walls7, n_dets7 = timed(1, padding=10)
    det.rotate_flags = 0
    stages = detect_stages(det.net, img)
    with detector_precision(None):
        tf32_walls, _ = timed(1)
        tf32_stages = detect_stages(det.net, img)
    k1 = k1_launches() - k1_0
    emit("detect", image=list(DET_HW), raw_init=raw_rec, build_s=build_s,
         warmup_s=warm_s,
         detect_s=walls, detections=n_dets, rotate7_padding10_s=walls7,
         rotate7_detections=n_dets7, stages=stages,
         peak_mem_bytes=peak, start_mem_bytes=start_mem,
         tf32={"detect_s": tf32_walls, "stages": tf32_stages},
         k1_launches=k1, repeat_of_warmup=repeat)
    check_no_k1("detect", k1)
    check_repeats("detect", repeat)
    if stages["rois"] == 0:
        raise AssertionError("detect: the proposal layer kept no RoI")


def phase_eccv20():
    """python -m xfr_torch.cli.eccv20 --figure 3 --subjects 2 on a
    synthetic 4-subject JPEG directory: full LightCNN-29 v2 on the card
    (ebp_version 5, affineonly_with_prior), every method; the six montages
    must exist with their grid's size.  Then the same with
    --use-detector, the CLI's FasterRCNN() given ``detector_params``: it
    must run detect() once for every image the figure reads (an image
    with no detection falls back to the center crop), and the montages
    keep their sizes."""
    import os
    import tempfile

    import PIL.Image
    from xfr_torch import detection
    from xfr_torch.cli import eccv20
    from xfr_torch.detection import detector as D

    tmp = tempfile.TemporaryDirectory()
    data = os.path.join(tmp.name, "data")
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
    want = {"figure3%s_2.jpg" % c: (3 * 113, (6 if c == "f" else 3) * 113)
            for c in "abcdef"}
    counts = {"images": 0, "detect": 0, "found": 0}
    crop, detect = eccv20.f_detection, D.FasterRCNN.detect
    params = detector_params()

    def counted_crop(imgfile, detector=None, out_size=224):
        counts["images"] += 1
        return crop(imgfile, detector, out_size)

    def counted_detect(self, image, **kw):
        counts["detect"] += 1
        dets = detect(self, image, **kw)
        counts["found"] += len(dets) > 0
        return dets

    rec = {}
    k1_0 = k1_launches()
    for run, extra in (("center_crop", []),
                       ("use_detector", ["--use-detector"])):
        out = os.path.join(tmp.name, run)
        os.makedirs(out)
        counts.update(images=0, detect=0, found=0)
        eccv20.f_detection, D.FasterRCNN.detect = counted_crop, counted_detect
        detection.FasterRCNN = functools.partial(D.FasterRCNN, params=params)
        try:
            t0 = time.time()
            outs = eccv20.main(["--dataset", data, "--output", out,
                                "--figure", "3", "--subjects", "2"] + extra)
            secs = time.time() - t0
        finally:
            eccv20.f_detection, D.FasterRCNN.detect = crop, detect
            detection.FasterRCNN = D.FasterRCNN
        sizes = {os.path.basename(f): PIL.Image.open(f).size for f in outs}
        rec[run] = dict(s=secs, files=sizes, **counts)
        if sizes != want:
            raise AssertionError(f"eccv20 {run}: montages {sizes}, "
                                 f"expected {want}")
    tmp.cleanup()
    k1 = k1_launches() - k1_0
    emit("eccv20", figure=3, subjects=2, net="lightcnn", k1_launches=k1,
         **rec)
    check_no_k1("eccv20", k1)
    det = rec["use_detector"]
    if rec["center_crop"]["detect"] or det["detect"] != det["images"] or \
            det["images"] == 0:
        raise AssertionError(f"eccv20: detect() ran {det['detect']} times "
                             f"for {det['images']} images")


# the training phases: bench-free fine-tuning steps on ResNet-101+L2
TRAIN_B, TRAIN_TIMED, TRAIN_CLASSES = 32, 5, 65359
# card against CPU (train_parity) and the mesh step against the plain one
# (train): float64 within these, float32 within the float32 limit or 3
# times the float32 CPU's (plain step's) own distance from float64
TRAIN_TOL = {"float64": {"loss_rtol": 1e-10, "leaf": 1e-8},
             "float32": {"loss_rtol": 1e-5, "leaf": 1e-3}}


def train_macs(graph, params, chw=(3, SIZE, SIZE)):
    """Multiply-adds of one image through ``graph`` (convolutions and
    linear layers, from the shapes on the meta device) and of its first
    convolution, whose input needs no gradient."""
    import torch
    from xfr_torch.ebp.interpreter import forward_values

    meta = {p: {k: torch.empty(v.shape, device="meta") for k, v in lv.items()}
            for p, lv in params.items()}
    vals = forward_values(graph, meta, torch.empty((1,) + chw, device="meta"))
    macs, first = 0, None
    for n in graph.nodes:
        if n.op in ("conv2d", "linear"):
            w = meta[n.pname]["w"]
            m = vals[n.out].numel() * (w[0].numel() if n.op == "conv2d"
                                       else w.shape[1])
            macs += m
            first = m if first is None else first
    return macs, first


def train_flops(graph, params, batch):
    """Floating-point operations of one training step: the forward, the
    weight gradients (the same products) and the input gradients (all but
    the first convolution's)."""
    macs, first = train_macs(graph, params)
    return 2 * batch * (3 * macs - first)


def leaf_updates(after, before):
    """{pname.key: after - before} as float64 on the CPU."""
    return {"%s.%s" % (p, k): (after[p][k].detach().double().cpu()
                               - before[p][k].double().cpu())
            for p in before for k in before[p]}


def one_train_step(graph, params, x, y, device, dtype, mesh=None):
    """One make_train_step step ("high") from ``params`` cast to ``dtype``:
    (loss, every leaf's update, the step's params)."""
    import torch
    from xfr_torch.models import common
    from xfr_torch.train.finetune import make_train_step

    start = common.params_to(params, device, dtype=dtype)
    step, init = make_train_step(graph, "fc2", mesh=mesh, device=device,
                                 precision="high")
    p, o = init(start)
    p, o, loss = step(p, o, x.to(device=device, dtype=dtype), y)
    if p["fc2"]["w"].is_cuda:
        torch.cuda.synchronize()
    return float(loss), leaf_updates(p, start), p


def step_errors(got, want):
    """``got``'s distance from ``want`` (each (loss, updates)): the loss's
    relative error, each updated leaf's max error over its largest update
    in ``want``, and whether the BN statistics' updates are all zero."""
    leaf, frozen = {}, True
    for name, u in want[1].items():
        if name.endswith((".mean", ".var")):
            frozen &= not got[1][name].any() and not u.any()
            continue
        leaf[name] = float((got[1][name] - u).abs().max()
                           / u.abs().max().clamp(min=1e-30))
    return {"loss_rel_err": abs(got[0] - want[0]) / abs(want[0]),
            "leaf_errs": leaf, "bn_stats_bit_identical": bool(frozen)}


def judged(errs, own32=None, per_leaf=False):
    """step_errors' record with its limits, worst leaf and "ok": float64
    (``own32`` None) within TRAIN_TOL["float64"]; float32 within
    TRAIN_TOL["float32"] or 3 times ``own32``, a float32 reference's own
    errors from float64: the loss's, and each leaf's own (``per_leaf``)
    or else the largest leaf's for every leaf."""
    tol = TRAIN_TOL["float64" if own32 is None else "float32"]
    leaf = errs["leaf_errs"]
    loss_lim = tol["loss_rtol"]
    lims = dict.fromkeys(leaf, tol["leaf"])
    if own32 is not None:
        own = own32["leaf_errs"]
        loss_lim = max(loss_lim, 3 * own32["loss_rel_err"])
        lims = {k: max(v, 3 * (own[k] if per_leaf else max(own.values())))
                for k, v in lims.items()}
    worst = max(leaf, key=lambda k: leaf[k] / lims[k])
    return {**errs, "loss_limit": loss_lim, "worst_leaf": worst,
            "worst_leaf_err": leaf[worst], "worst_leaf_limit": lims[worst],
            "median_leaf_err": float(np.median(list(leaf.values()))),
            "leaves": len(leaf),
            "ok": bool(errs["loss_rel_err"] <= loss_lim
                       and errs["bn_stats_bit_identical"]
                       and all(leaf[k] <= lims[k] for k in leaf))}


def public(rec):
    """A step_errors record without its per-leaf table (its largest entry
    kept)."""
    out = {k: v for k, v in rec.items() if k != "leaf_errs"}
    out["max_leaf_err"] = max(rec["leaf_errs"].values())
    return out


def phase_train_parity():
    """One make_train_step step and one make_eval_step on ResNet-101+L2 at
    full widths (512-d fc1, 65,359 classes) with one block a stage, B=4
    random 224x224 images, on the card under "high" and on the CPU, the
    same numpy-init weights, in float64 and in float32.  Labels: the
    first two rows take their argmax class at the start weights (so hits
    count), the others are drawn from a seed.  Float64: the card's loss
    and every updated leaf's update against the CPU's within
    TRAIN_TOL["float64"].  Float32 is ill-conditioned at random weights
    (the BN betas' gradients are sums over the batch and the plane that
    cancel: the CPU's own float32 updates lie up to 1.4% of their max
    from float64 here), so the card's float32 step is held against the
    float64 CPU within TRAIN_TOL["float32"] or 3 times the CPU's own
    float32 error (judged).  Equal hits; the BN statistics bit-identical
    to their start on both devices in both dtypes.  Read on an NVIDIA
    H100 80GB HBM3 at 700 W: float64 loss 3.4e-16, worst leaf 7.1e-13
    (fc1.w); float32 loss 7.4e-8, worst leaf 1.36e-2 (layer4.0.bn1.beta)
    against a limit of 4.1e-2; hits 2 and 2."""
    import torch
    from xfr_torch.ebp.interpreter import forward_clean
    from xfr_torch.models import common
    from xfr_torch.models import resnet101 as R101
    from xfr_torch.train.finetune import make_eval_step

    k1_0 = k1_launches()
    graph, shapes, _ = R101.build_resnet101(layers=(1, 1, 1, 1))
    params = common.init_params(shapes, seed=4)
    rng = np.random.RandomState(8)
    x = torch.as_tensor(rng.rand(4, 3, SIZE, SIZE) * 50, dtype=torch.float32)
    y = torch.as_tensor(rng.randint(0, TRAIN_CLASSES, 4))
    y[:2] = forward_clean(graph, params, x[:2])[graph.output_id].argmax(1)
    steps, evals, secs = {}, {}, {}
    f32, f64 = torch.float32, torch.float64
    for dt in (f64, f32):
        for dev in ("cpu", "cuda"):
            t0 = time.time()
            loss, upd, p = one_train_step(graph, params, x, y, dev, dt)
            ev_loss, hits = make_eval_step(graph, device=dev,
                                           precision="high")(
                p, x.to(device=dev, dtype=dt), y)
            steps[dev, dt] = (loss, upd)
            evals[dev, dt] = {"loss": loss, "eval_loss": float(ev_loss),
                              "hits": int(hits)}
            secs[dev, dt] = time.time() - t0
            del p
    own32 = step_errors(steps["cpu", f32], steps["cpu", f64])
    rec = {"float64": judged(step_errors(steps["cuda", f64],
                                         steps["cpu", f64])),
           "float32": judged(step_errors(steps["cuda", f32],
                                         steps["cpu", f64]), own32)}
    ok = all(r["ok"] for r in rec.values())
    for dt in (f64, f32):
        e_c, e_p = evals["cuda", dt], evals["cpu", dt]
        r = rec[str(dt).replace("torch.", "")]
        r["eval_loss_rel_err"] = abs(e_c["eval_loss"] - e_p["eval_loss"]) / \
            abs(e_p["eval_loss"])
        r["hits"] = [e_c["hits"], e_p["hits"]]
        ok &= (e_c["hits"] == e_p["hits"]
               and r["eval_loss_rel_err"] <= r["loss_limit"])
    k1 = k1_launches() - k1_0
    emit("train_parity", layers=[1, 1, 1, 1], classes=TRAIN_CLASSES, batch=4,
         precision="high", steps={"%s_%s" % (d, str(t)[6:]): v
                                  for (d, t), v in evals.items()},
         float64=public(rec["float64"]), float32=public(rec["float32"]),
         cpu_float32_own=public(own32),
         seconds={"%s_%s" % (d, str(t)[6:]): v for (d, t), v in secs.items()},
         tol=TRAIN_TOL, k1_launches=k1)
    check_no_k1("train_parity", k1)
    if not ok:
        raise AssertionError(f"train_parity: card and CPU disagree: "
                             f"{public(rec['float64'])} "
                             f"{public(rec['float32'])}")


def train_batch(tmp, seed=0):
    """TRAIN_B images on the card through TripletDataLoader and
    preprocess_resnet101: a synthetic filtered CSV of 8 subjects (mask 0),
    each one probe and 3 refs of 250x250 JPEGs; each item gives its probe
    and its 3 mates.  Labels drawn from ``seed``."""
    import os

    import pandas as pd
    import PIL.Image
    import torch
    from xfr_torch.data import TripletDataLoader
    from xfr_torch.models.resnet101 import preprocess_resnet101

    rng = np.random.RandomState(seed)
    rows = []
    for sid in range(TRAIN_B // 4):
        for k, trip in enumerate(("PROBE", "REF", "REF", "REF")):
            names = []
            for kind in ("orig", "inp"):
                name = "s%d_%d_%s.jpg" % (sid, k, kind)
                PIL.Image.fromarray((rng.rand(250, 250, 3) * 255).astype(
                    np.uint8)).save(os.path.join(tmp, name))
                names.append(name)
            rows.append({"SUBJECT_ID": sid, "MASK_ID": 0, "TRIPLET_SET": trip,
                         "OriginalFile": names[0], "InpaintingFile": names[1]})
    csv = os.path.join(tmp, "filtered.csv")
    pd.DataFrame(rows).to_csv(csv, index=False)
    loader = TripletDataLoader(
        csv, data_root=tmp,
        transform=lambda im: preprocess_resnet101(im, device="cuda"))
    xs = []
    for i in range(len(loader)):
        probe, mates, _ = loader[i]
        xs += [probe, mates]
    x = torch.cat(xs)
    y = torch.as_tensor(rng.randint(0, TRAIN_CLASSES, len(x)), device="cuda")
    return x, y


def timed_train_steps(step, p, o, x, y, n):
    """``n`` steps, each between two CUDA events (stream time, any wait
    for the host included), the host clock around all ``n`` ended by a
    synchronize; the losses read after the last."""
    import torch

    ev = [torch.cuda.Event(enable_timing=True) for _ in range(n + 1)]
    losses = []
    torch.cuda.synchronize()
    t0 = time.time()
    ev[0].record()
    for i in range(n):
        p, o, loss = step(p, o, x, y)
        ev[i + 1].record()
        losses.append(loss)
    torch.cuda.synchronize()
    wall = time.time() - t0
    ms = [ev[i].elapsed_time(ev[i + 1]) for i in range(n)]
    return p, o, {"step_ms": ms, "median_step_ms": float(np.median(ms)),
                  "images_per_s": len(x) * 1e3 / float(np.median(ms)),
                  "host_wall_s": wall, "losses": [float(v) for v in losses]}


def train_step_profile(step, p, o, x, y):
    """One step under torch.profiler: its wall time (host clock, ended by a
    synchronize), the device busy time (every kernel, copy and set; one
    stream), the idle share, kernel launches and device time by group."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from tools.torch_strise_profile import group_of

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        step(p, o, x, y)
        torch.cuda.synchronize()
        wall = time.time() - t0
    groups, busy_us, launches = {}, 0.0, 0
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
            busy_us += e.self_device_time_total
            launches += e.count
            g = groups.setdefault(group_of(e.key), {"ms": 0.0, "launches": 0})
            g["ms"] += e.self_device_time_total / 1e3
            g["launches"] += e.count
    return {"step_s_profiled": wall, "device_busy_ms": busy_us / 1e3,
            "idle_share": 1.0 - busy_us / 1e6 / wall,
            "kernel_launches": launches, "groups": dict(
                sorted(groups.items(), key=lambda kv: -kv[1]["ms"]))}


def step_state(p, loss):
    """A copy of a train step's loss and every leaf after it."""
    return {"loss": loss.detach().clone(), "leaves": {
        k: {kk: v.detach().clone() for kk, v in leaves.items()}
        for k, leaves in p.items()}}


def mesh_step_check(graph, params, x, y):
    """make_train_step(mesh=make_mesh((1, 1))) on a one-rank NCCL group
    (file:// rendezvous) against the plain step, one step each from the
    same start weights and batch under "high": in float64 within
    TRAIN_TOL["float64"]; in float32, each leaf within TRAIN_TOL["float32"]
    of the float32 plain step or 3 times that step's own distance from
    float64 for the leaf (the vocab-parallel loss sums in another order
    than F.cross_entropy, and at random weights float32 rounding is
    amplified in the leaves whose gradients cancel, as train_parity's
    docstring says: at full depth the plain float32 step lies up to 100%
    of a BN beta's largest update from float64).  Read on an NVIDIA H100
    80GB HBM3 at 700 W: float64 worst leaf 3.3e-11 to 5.8e-11, loss 0;
    float32 loss 0, worst leaf 1.18e-2 of its largest update against a
    limit of 3.6e-2, median 0."""
    import os
    import tempfile

    import torch
    import torch.distributed as dist
    from xfr_torch.parallel import distributed as D
    from xfr_torch.parallel.mesh import make_mesh

    f32, f64 = torch.float32, torch.float64
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        D.initialize("file://" + os.path.join(tmp, "rendezvous"), 1, 0)
        try:
            backend = dist.get_backend()
            mesh = make_mesh((1, 1), ("dp", "mp"))
            for dt in (f64, f32):
                for name, m in (("plain", None), ("mesh", mesh)):
                    runs[name, dt] = one_train_step(graph, params, x, y,
                                                    "cuda", dt, mesh=m)[:2]
        finally:
            dist.destroy_process_group()
    own32 = step_errors(runs["plain", f32], runs["plain", f64])
    r64 = judged(step_errors(runs["mesh", f64], runs["plain", f64]))
    r32 = judged(step_errors(runs["mesh", f32], runs["plain", f32]), own32,
                 per_leaf=True)
    return {"backend": backend, "mesh": [1, 1],
            "losses": {"%s_%s" % (n, str(t)[6:]): v[0]
                       for (n, t), v in runs.items()},
            "float64": public(r64), "float32": public(r32),
            "plain_float32_own": public(own32),
            "ok": bool(backend == "nccl" and r64["ok"] and r32["ok"])}


def phase_train():
    """Fine-tuning on full ResNet-101+L2 (create_wbnet("resnetv6_pytorch"):
    348 nodes, 65,359 classes, its own fc2): a B=32 batch of 224x224
    images from TripletDataLoader (train_batch), integer labels from a
    seed.  One warm-up step, then TRAIN_TIMED timed steps under "high"
    and TRAIN_TIMED under None (TF32), each from the same start weights:
    step time by CUDA events, images/s, every step's loss (finite), peak
    memory after a gc.collect() beside what was resident at the start,
    and one profiled step's idle share and device time by group; then a
    second first step from the start weights, whose loss and leaves must
    equal the warm-up's bit for bit.  Then the one-rank NCCL mesh step
    against the plain step (mesh_step_check).  K1 must launch 0
    times."""
    import tempfile

    import torch
    from xfr_torch.models import create_wbnet
    from xfr_torch.train.finetune import make_train_step

    k1_0 = k1_launches()
    t0 = time.time()
    wb = create_wbnet("resnetv6_pytorch", device="cuda")
    net_s = time.time() - t0
    graph, params = wb.net.graph, wb.net.params
    if (len(graph.nodes), wb.net.num_classes()) != (348, TRAIN_CLASSES):
        raise AssertionError("ResNet-101+L2: %d nodes, %d classes" % (
            len(graph.nodes), wb.net.num_classes()))
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.time()
        x, y = train_batch(tmp)
        torch.cuda.synchronize()
        loader_s = time.time() - t0
    flops = train_flops(graph, params, len(x))
    rec = {"nodes": len(graph.nodes), "classes": wb.net.num_classes(),
           "batch": list(x.shape), "net_s": net_s, "loader_s": loader_s,
           "flops_per_step": flops,
           "bound_ms": {"high": 1e3 * flops / F32_FLOPS_PER_S,
                        "None": 1e3 * flops / TF32_FLOPS_PER_S}}
    ok = True
    for precision in ("high", None):
        gc.collect()
        torch.cuda.reset_peak_memory_stats()
        start_mem = torch.cuda.memory_allocated()
        step, init = make_train_step(graph, "fc2", device="cuda",
                                     precision=precision)
        p, o = init(params)
        t0 = time.time()
        p, o, loss = step(p, o, x, y)
        warm = {"loss": float(loss), "s": time.time() - t0}
        first = step_state(p, loss)
        p, o, r = timed_train_steps(step, p, o, x, y, TRAIN_TIMED)
        r.update(warmup=warm, peak_mem_bytes=torch.cuda.max_memory_allocated(),
                 start_mem_bytes=start_mem,
                 profile=train_step_profile(step, p, o, x, y))
        ok &= bool(np.isfinite([warm["loss"]] + r["losses"]).all())
        rec[str(precision)] = r
        p, o = init(params)
        p, o, loss = step(p, o, x, y)
        r["first_step_repeat"] = repeat_diff(step_state(p, loss), first)
        del p, o, first, step, init
    rec["mesh_step"] = mesh_step_check(graph, params, x, y)
    k1 = k1_launches() - k1_0
    emit("train", **rec, k1_launches=k1)
    check_no_k1("train", k1)
    for precision in ("high", "None"):
        check_repeats("train, " + precision,
                      {"first_step": rec[precision]["first_step_repeat"]})
    if not ok or not rec["mesh_step"]["ok"]:
        raise AssertionError(f"train: non-finite losses or the mesh step "
                             f"disagrees: {rec}")


# ---------------------------------------------------------------------------
# The inference side under a device mesh
# ---------------------------------------------------------------------------

MESH_TIMED = 1       # timed mixes; STRise maps are 1, eval groups 3
MESH_REL = 1e-6      # mean-EBP at the full shapes, another batch size
MESH_RANK_S = 420    # each rank of the two-process form


def mesh_workloads(wb, w, ew, net_dict, mesh=None, strise_batch=CHUNK):
    """The mesh phase's three workloads on the main path's net ``wb``
    (full ResNet-101+L2, bfloat16 sweep), meshed or not: the 4-map mix
    on ``w`` (one warm-up with every host sync refused during the
    launches, then MESH_TIMED mixes one at a time, whose results must be
    the warm-up's bit for bit), one STRise map
    (6,500 masks, mean-EBP prior, "high", K1, chunks of
    ``strise_batch``) with K1's launches counted from 0, and the eval
    group of ``ew`` (a warm-up with host syncs refused during its
    launches and flush, then 3 timed).  Under a mesh every timed run
    starts at a barrier.  Returns (results: numpy arrays, record: times,
    launches, peak)."""
    import torch
    import torch.distributed as dist

    from xfr_torch.blackbox import fused_blend as FB

    def start():
        if mesh is not None:
            dist.barrier()
        torch.cuda.synchronize()
        return time.time()

    res, rec = {}, {}
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    with host_syncs_refused(True):
        launched = BT.launch_mix(wb, w)
    first = BT.drain_mix(wb, launched)
    mix_s = []
    for _ in range(MESH_TIMED):
        t0 = start()
        out = BT.drain_mix(wb, BT.launch_mix(wb, w))
        torch.cuda.synchronize()
        mix_s.append(time.time() - t0)
    check_wb_maps(out)
    wb.net.reset_classifier()
    res.update(mix_results(out))
    B = len(out["mean_ebp"])
    rec["mix"] = {"s": mix_s, "maps_per_s": 4 * B * len(mix_s) / sum(mix_s),
                  "run_to_run": mesh_exact(res, mix_results(first))[1]}
    check_repeats("mesh workloads' mix", rec["mix"]["run_to_run"])

    t0 = start()
    FB.fused_mask_blend_preprocess.launches = 0
    st = make_main_path_strise(net_dict, 1, use_pallas_blend=True,
                               score_precision="high", mesh=mesh,
                               batch_size=strise_batch)
    smap = st.launch_evaluate()()
    torch.cuda.synchronize()
    launches = FB.fused_mask_blend_preprocess.launches
    check_map(smap)
    res["st_map"], res["st_scores"] = smap, st.mask_scores
    raw = st.combine_masks(st.mask_scores > 0)
    rec["strise"] = {"s": time.time() - t0, "k1_launches": launches,
                     "k1_rows": strise_batch // (
                         1 if mesh is None else mesh.size(0)),
                     "raw_range": float(raw.max() - raw.min())}

    with host_syncs_refused(True):
        launched = BT.launch_eval_group(wb, ew, 0)
    BT.drain_eval_group(launched)
    eval_s = []
    for _ in range(3):
        t0 = start()
        got = BT.drain_eval_group(BT.launch_eval_group(wb, ew, 0))
        eval_s.append(time.time() - t0)
    for i, (cls, pg, pr) in enumerate(got):
        res["eval_cls%d" % i] = np.asarray(cls)
        res["eval_pg%d" % i], res["eval_pr%d" % i] = pg, pr
    rec["eval"] = {"s": eval_s,
                   "evals_per_s": EVAL_MAPS * len(eval_s) / sum(eval_s)}
    rec["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    return res, rec


def mix_results(out):
    """A drained mix as arrays: each method's maps stacked, each probe's
    selected subtrees padded with -1."""
    res = {"mix_" + k: np.stack(out[k]) for k in (
        "mean_ebp", "contrastive", "truncated_contrastive",
        "weighted_subtree")}
    res["mix_subtrees"] = np.array([k + [-1] * (WB_TOPK - len(k))
                                    for k in out["subtrees"]])
    return res


def mesh_errors(got, want):
    """{result: largest difference over the reference's largest value}
    (0 or 1 for integer results: equal or not)."""
    out = {}
    for k, v in want.items():
        g = np.asarray(got[k])
        if v.dtype.kind in "biu":
            out[k] = float(not np.array_equal(g, v))
        else:
            scale = max(float(np.abs(v).max()), 1e-30)
            out[k] = float(np.abs(g.astype(np.float64) - v).max()) / scale
    return out


def mesh_exact(got, want):
    """Whether ``got`` holds ``want`` bit for bit, result by result (the
    same rows through the same programs give the same bits on the card).
    Returns (ok, {result: repeat_diff})."""
    diffs = {k: repeat_diff(np.asarray(got[k]), np.asarray(v))
             for k, v in want.items()}
    return all(d == 0.0 for d in diffs.values()), diffs


def mesh_judged_full_shapes(got, want):
    """Whether (b)'s mix holds the plain mix at the full shapes, where
    cuDNN sees other batch sizes: the mean-EBP maps within MESH_REL of
    their largest value, the contrastive and truncated-contrastive maps
    (differences of near-equal distributions) at correlation 0.999 or
    more, as wb_parity holds them, and the bfloat16 weighted-subtree
    maps as wsebp_bf16 gates the bfloat16 sweep (correlation above 0.98,
    2 of 3 subtrees shared).  Returns (ok, readings)."""
    err = mesh_errors(got, want)
    corr = {k: min(float(np.corrcoef(a.ravel(), b.ravel())[0, 1])
                   for a, b in zip(got[k], want[k]))
            for k in ("mix_contrastive", "mix_truncated_contrastive",
                      "mix_weighted_subtree")}
    shared, need = [], []
    for a, b in zip(got["mix_subtrees"].tolist(),
                    want["mix_subtrees"].tolist()):
        a, b = {k for k in a if k >= 0}, {k for k in b if k >= 0}
        shared.append(len(a & b))
        need.append(-(-2 * len(b) // 3))
    ok = (err["mix_mean_ebp"] <= MESH_REL
          and corr["mix_contrastive"] >= 0.999
          and corr["mix_truncated_contrastive"] >= 0.999
          and all(s >= n for s, n in zip(shared, need))
          and corr["mix_weighted_subtree"] > 0.98)
    return ok, {"rel_to_max": err, "min_corr": corr,
                "subtrees_shared": shared, "subtrees_needed": need}


def mesh_rank(rank, world, init_file, out_dir):
    """One rank of the two-process form: a gloo group joined through
    ``init_file`` (torch.distributed's own call: distributed.initialize
    picks NCCL whenever a card is present), a (world, 1) mesh whose
    collectives go through the host, the main path's net on the card and
    the parent's inputs (``out_dir/inputs.pkl``), mesh_workloads; rank 0
    writes the gathered results, each rank its record."""
    import pickle

    import torch
    import torch.distributed as dist

    from xfr_torch.parallel.mesh import make_mesh

    warnings.filterwarnings("error", message=".*performance drop.*")
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method="file://" + init_file,
                            world_size=world, rank=rank)
    try:
        with open(os.path.join(out_dir, "inputs.pkl"), "rb") as f:
            w, ew = pickle.load(f)
        w = {k: torch.as_tensor(v, device="cuda") for k, v in w.items()}
        mesh = make_mesh((world, 1), ("dp", "mp"))
        wb, net_dict = main_path_net()
        wb.wsebp_dtype = torch.bfloat16
        wb.use_mesh(mesh)
        res, rec = mesh_workloads(wb, w, ew, net_dict, mesh)
        rec["mesh_device"] = mesh.device_type
        if rank == 0:
            np.savez(os.path.join(out_dir, "results.npz"), **res)
        with open(os.path.join(out_dir, "rank%d.json" % rank), "w") as f:
            json.dump(rec, f)
    finally:
        dist.destroy_process_group()


def mesh_two_ranks(w, ew, world=2):
    """The two-process form on the inputs ``w`` and ``ew``: ``world``
    ranks sharing the card, each a fresh ``python3 -c`` of mesh_rank with
    a time limit; a rank that fails, times out or exits non-zero fails
    the phase, and every rank is stopped before this returns.  Returns
    (rank 0's results, the ranks' records, seconds)."""
    import pickle
    import tempfile

    here = os.path.dirname(os.path.abspath(__file__))
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE",
                        "LOCAL_RANK")}
    with tempfile.TemporaryDirectory() as tmp:
        with open(os.path.join(tmp, "inputs.pkl"), "wb") as f:
            pickle.dump(({k: v.cpu().numpy() for k, v in w.items()}, ew), f)
        init = os.path.join(tmp, "rendezvous")
        logs = [open(os.path.join(tmp, "rank%d.log" % r), "w+")
                for r in range(world)]
        t0 = time.time()
        procs = [subprocess.Popen(
            [sys.executable, "-c",
             "import sys; sys.path.insert(0, %r); import chip_smoke as c; "
             "c.mesh_rank(%d, %d, %r, %r)" % (here, r, world, init, tmp)],
            stdout=logs[r], stderr=subprocess.STDOUT, cwd=here, env=env)
            for r in range(world)]
        try:
            for p in procs:
                p.wait(timeout=max(1.0, MESH_RANK_S - (time.time() - t0)))
        except subprocess.TimeoutExpired:
            pass
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        seconds = time.time() - t0
        tails = []
        for f in logs:
            f.seek(0)
            tails.append(f.read()[-2000:])
            f.close()
        codes = [p.returncode for p in procs]
        if any(c != 0 for c in codes):
            raise AssertionError(f"mesh ranks exited {codes}: {tails}")
        with np.load(os.path.join(tmp, "results.npz")) as d:
            res = dict(d)
        recs = []
        for r in range(world):
            with open(os.path.join(tmp, "rank%d.json" % r)) as f:
                recs.append(json.load(f))
    return res, recs, seconds


def phase_mesh():
    """The inference side's device-mesh forms on full ResNet-101+L2
    (mesh_workloads: the B=8 mix, one STRise map through K1, one eval
    group), in the two forms that fit one card, each on the plain calls'
    inputs and held against the plain calls' results:

    (a) a (1, 1) mesh on a one-rank NCCL group in this process: the same
        rows through the same programs, so every result the plain call's
        bit for bit (mesh_exact).
    (b) two processes sharing the card (mesh_two_ranks), a (2, 1) mesh
        over gloo, each rank computing on the card on its half of the
        rows: 4 of the 8 probes, 32 of each 64-mask chunk (K1 at N=32,
        102 launches a rank), half the blend steps.  Its exact reference
        is the plain call at the shapes a rank runs (the mix on probes
        0-3 and 4-7, STRise in chunks of 32; the eval's steps keep their
        shape; the mix's mean-EBP is the full-classifier program bench.py
        calls directly, which no package meshes, so each rank runs it
        whole): every result those calls' bit for bit (mesh_exact).
        Against the plain calls at the full shapes cuDNN sees other batch
        sizes: the mix is then held by mesh_judged_full_shapes, and
        STRise's map to phase_branches' limit (4 float32 steps of the
        normalized map plus 1e-3) with scores within 1e-6.

    K1 must launch 102 times in (a) and on each rank of (b).  The record
    has each form's rates: (b)'s maps/s counts the B maps the two ranks
    make together, beside the plain one-process rate."""
    import tempfile

    import torch
    import torch.distributed as dist

    from xfr_torch.parallel import distributed as D
    from xfr_torch.parallel.mesh import make_mesh

    wb, net_dict = main_path_net()
    wb.wsebp_dtype = torch.bfloat16
    w = BT.whitebox_workload(wb, np.random.RandomState(0), WB_B)
    ew = BT.eval_workload(wb, np.random.RandomState(0))
    plain, plain_rec = mesh_workloads(wb, w, ew, net_dict)
    # (b)'s exact references: the rows a rank runs, as plain calls
    halves = [mix_results(BT.drain_mix(wb, BT.launch_mix(
        wb, dict(w, probes=w["probes"][i:i + WB_B // 2]))))
        for i in (0, WB_B // 2)]
    wb.net.reset_classifier()
    half_ref = {k: np.concatenate([h[k] for h in halves])
                for k in halves[0] if k != "mix_mean_ebp"}
    st = make_main_path_strise(net_dict, 1, use_pallas_blend=True,
                               score_precision="high", batch_size=CHUNK // 2)
    half_ref["st_map"] = st.launch_evaluate()()
    half_ref["st_scores"] = st.mask_scores

    with tempfile.TemporaryDirectory() as tmp:
        D.initialize("file://" + os.path.join(tmp, "rendezvous"), 1, 0)
        try:
            backend = dist.get_backend()
            wb.use_mesh(make_mesh((1, 1), ("dp", "mp")))
            one, one_rec = mesh_workloads(wb, w, ew, net_dict, wb.mesh)
            wb.use_mesh(None)
        finally:
            dist.destroy_process_group()
    del wb, net_dict, st
    gc.collect()
    torch.cuda.empty_cache()

    two, two_recs, two_s = mesh_two_ranks(w, ew)

    ok_a, read_a = mesh_exact(one, plain)
    ok_b, read_b = mesh_exact(two, {**plain, **half_ref})
    ok_full, read_full = mesh_judged_full_shapes(
        {k: two[k] for k in plain if k.startswith("mix_")},
        {k: plain[k] for k in plain if k.startswith("mix_")})
    # phase_branches' limit: 4 float32 steps near 1.0 of the normalized
    # map, plus 1e-3
    map_atol = 1e-3 + 4 * float(np.spacing(np.float32(0.5))) / \
        plain_rec["strise"]["raw_range"]
    st_full = {"score_max_abs_diff": float(np.abs(
        two["st_scores"] - plain["st_scores"]).max()),
        "map_max_abs_diff": float(np.abs(
            two["st_map"] - plain["st_map"]).max())}
    per_map = -(-N_MASKS // CHUNK)
    checks = {
        "a_same_rows": ok_a, "b_same_shapes": ok_b,
        "b_full_shapes_mix": ok_full,
        "b_full_shapes_strise": st_full["score_max_abs_diff"] <= 1e-6
        and st_full["map_max_abs_diff"] <= map_atol,
        "k1_one_rank": one_rec["strise"]["k1_launches"] == per_map,
        "k1_each_rank": all(r["strise"]["k1_launches"] == per_map
                            for r in two_recs),
        "nccl": backend == "nccl",
        "gloo_ranks": all(r["mesh_device"] == "cpu" for r in two_recs)}
    emit("mesh", plain=plain_rec, one_rank_nccl=one_rec,
         two_ranks_gloo=two_recs, two_ranks_s=two_s, backend=backend,
         readings={"a_vs_plain": read_a, "b_vs_same_shapes": read_b,
                   "b_vs_full_shapes": dict(read_full, strise=st_full)},
         tol={"a_and_b_same_shapes": "bit for bit",
              "full_mean_ebp_rel_to_max": MESH_REL,
              "full_contrastive_corr_min": 0.999, "full_ws_corr_min": 0.98,
              "strise_score_atol": 1e-6, "strise_map_atol": map_atol},
         maps_per_s={"plain": plain_rec["mix"]["maps_per_s"],
                     "one_rank": one_rec["mix"]["maps_per_s"],
                     "two_ranks_combined": two_recs[0]["mix"]["maps_per_s"]},
         checks=checks)
    if not all(checks.values()):
        raise AssertionError(f"mesh phase: {checks}")


# ---------------------------------------------------------------------------
# The demos (python -m xfr_torch.demo.whitebox / .blackbox)
# ---------------------------------------------------------------------------

DEMO_WB_FILES = ["test_whitebox_%s.jpg" % n for n in (
    "ebp", "contrastive_ebp", "truncated_contrastive_ebp", "triplet_ebp",
    "contrastive_triplet_ebp", "truncated_contrastive_triplet_ebp",
    "weighted_subtree_ebp_topk_64_mask_nose", "ebp_resnet50_128",
    "ebp_lightcnn")]


def run_demo(module, argv):
    """``python -m module argv`` in this process (runpy, as ``-m`` runs
    it), its standard output kept: (seconds, output lines)."""
    import io
    import runpy

    buf, saved = io.StringIO(), sys.argv
    sys.argv = [module] + list(argv)
    t0 = time.time()
    try:
        with contextlib.redirect_stdout(buf):
            runpy.run_module(module, run_name="__main__", alter_sys=True)
    finally:
        sys.argv = saved
    return time.time() - t0, buf.getvalue().splitlines()


def phase_demos():
    """The two demos at full width on the card, as a user runs them, each
    into a temporary --outdir: ``python -m xfr_torch.demo.whitebox
    --quick`` (full ResNet-101+L2 "resnetv4_pytorch": the six EBP and
    contrastive scenarios, the weighted-subtree triplet top-64 over every
    candidate; full ResNet-50-128 and LightCNN-29 v2), ``python -m
    xfr_torch.demo.blackbox`` (STRise, 6,500 masks, mean-EBP prior, the
    built-in resnetv6 scorer on the materialized masks) and ``--custom-bb
    --num-masks 650`` (the score-only contract, uniform prior).  Each
    must write the JAX demo's files as non-empty JPEGs, and the blackbox
    demo print its positive-score count of all the masks; wall seconds of
    each.  The demos keep STRise's default materialized-mask path: K1
    must launch 0 times."""
    import tempfile

    import PIL.Image

    k1_0 = k1_launches()
    rec, ok = {}, True
    runs = (("whitebox", "xfr_torch.demo.whitebox", ["--quick"],
             DEMO_WB_FILES, None),
            ("blackbox", "xfr_torch.demo.blackbox", [],
             ["blackbox_demo_subject_0_resnetv6.jpg"], N_MASKS),
            ("blackbox_custom_bb", "xfr_torch.demo.blackbox",
             ["--custom-bb", "--num-masks", "650"],
             ["blackbox_demo_subject_0_custom.jpg"], 650))
    for name, module, argv, files, masks in runs:
        with tempfile.TemporaryDirectory() as tmp:
            secs, lines = run_demo(module, argv + ["--outdir", tmp])
            got = sorted(os.listdir(tmp))
            sizes = [PIL.Image.open(os.path.join(tmp, f)).size for f in got]
        r = {"s": secs, "files": len(got), "sizes": sorted(set(sizes))}
        good = got == sorted(files) and all(w > 0 and h > 0
                                            for w, h in sizes)
        if masks is not None:
            count = [ln for ln in lines if ln.startswith("mask_scores:")]
            r["printed"] = count
            good &= len(count) == 1 and count[0].endswith(" of %d" % masks)
        r["ok"] = bool(good)
        ok &= good
        rec[name] = r
        gc.collect()
    k1 = k1_launches() - k1_0
    emit("demos", **rec, k1_launches=k1)
    check_no_k1("demos", k1)
    if not ok:
        raise AssertionError(f"demos: {rec}")


# ---------------------------------------------------------------------------
# Which operations have no deterministic form (run alone, not by main)
# ---------------------------------------------------------------------------


def phase_audit():
    """The paths of this script once each at reduced size (ResNet-101 at
    full widths with one block a stage; the detector at full width) under
    ``torch.use_deterministic_algorithms(True)`` with
    CUBLAS_WORKSPACE_CONFIG=:4096:8: every operation PyTorch knows to have
    no deterministic form raises there, and its message names it.  (An
    operation that has one, as a scatter-add or cuDNN's algorithms,
    switches to it silently: those sources show in the repeats of the
    whole script.)
    Sets process-wide state, so it must be the first use of the card in
    its process:

        python3 -c "import chip_smoke as c; c.phase_audit()"
    """
    import tempfile

    import torch

    if torch.cuda.is_initialized():
        raise RuntimeError("phase_audit must run before the card is used")
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True)
    from xfr_torch.blackbox.strise import STRise
    from xfr_torch.detection import FasterRCNN
    from xfr_torch.inpainting_game import generate as G
    from xfr_torch.models import resnet101 as R101
    from xfr_torch.train.finetune import make_train_step

    wb = whitebox_net("cuda", layers=(1, 1, 1, 1))
    wb.wsebp_dtype = torch.bfloat16
    # the generator preprocesses its jobs' images
    wb.net._preprocess = functools.partial(R101.preprocess_resnet101,
                                           device="cuda")
    w = BT.whitebox_workload(wb, np.random.RandomState(0), B=2)
    x1 = w["probes"][:1]
    net_dict = {("resnetv6_pytorch", 6): wb, ("resnetv4_pytorch", None): wb,
                ("resnetv4_pytorch", 6): wb}
    probe, ref, gal = _images(8, 3)

    def mix():
        BT.drain_mix(wb, BT.launch_mix(wb, w))
        wb.net.reset_classifier()

    def per_probe():
        wb.net.set_triplet_classifier(w["em"], w["en"])
        for kw in WSEBP_PATHS.values():
            wb.weighted_subtree_ebp(x1, 0, 1, topk=WB_TOPK,
                                    subtree_mode="norelu", **kw)
        wb.net.reset_classifier()

    def variants():
        k = 37
        P = wb._ebp_raw_fn((k,))(wb.net.params, x1, wb._onehot(0))[k]
        for call in variant_calls(wb, x1, k, int(P.reshape(-1).argmax()),
                                  percentile_mode=True).values():
            call()

    def strise(precision, fused):
        st = STRise(probe=probe, refs=[ref], gallery=[gal],
                    black_box="resnetv6_pytorch", net_dict=net_dict,
                    num_masks=640, mask_scale=SCALE, num_mask_elements=ELEMS,
                    use_pallas_blend=fused, score_precision=precision,
                    device="cuda")
        st.launch_evaluate()()

    def eval_group():
        BT.drain_eval_group(BT.launch_eval_group(
            wb, BT.eval_workload(wb, np.random.RandomState(0)), 0))

    def generator():
        with tempfile.TemporaryDirectory() as tmp:
            group = [G.prepare_wb_job(wb, j, *j["images"])
                     for j in generation_jobs(2)]
            G.drain_wb_group(wb, G.launch_wb_group(wb, group, 2, "norelu",
                                                   6),
                             npz_writer(tmp, []))

    def detect():
        FasterRCNN(conf_threshold=-1.0,
                   params=detector_params()).detect(detect_image())

    def train(precision):
        step, init = make_train_step(wb.net.graph, "fc2", device="cuda",
                                     precision=precision)
        p, o = init(wb.net.params)
        step(p, o, torch.rand((4, 3, SIZE, SIZE), device="cuda"),
             torch.arange(4, device="cuda"))

    paths = {"mix": mix, "weighted_subtree_per_probe": per_probe,
             "layerwise_and_subtree": variants,
             "strise_high_k1": lambda: strise("high", True),
             "strise_tf32_materialized": lambda: strise(None, False),
             "eval_group": eval_group, "batched_generator": generator,
             "detect": detect, "train_high": lambda: train("high"),
             "train_tf32": lambda: train(None)}
    raised = {}
    for name, fn in paths.items():
        try:
            fn()
            torch.cuda.synchronize()
        except RuntimeError as e:
            raised[name] = str(e)[:400]
    emit("audit", paths=sorted(paths), raised=raised,
         cublas_workspace_config=os.environ["CUBLAS_WORKSPACE_CONFIG"])


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
    card = phase_device()
    phase_build()
    k1 = phase_kernel()
    epilogue = phase_epilogue()
    phase_precision()
    phase_prior()
    wb, make, st_k, launches, main_s, epilogue["launches"] = main_path()
    phase_branches(make, st_k)
    phase_tf32(make, st_k)
    phase_breakdown(wb, make, k1["ms"], st_k)
    phase_pipeline(wb, make, main_s)
    k1["launches"] = launches
    del wb, make, st_k
    phase_wb_parity()
    wb, w = phase_whitebox()
    phase_wsebp_bf16(wb, w)
    phase_bench(wb)
    del wb, w
    phase_eval_parity()
    phase_eval()
    phase_wsebp_parity()
    phase_generate()
    phase_models_parity()
    phase_lightcnn()
    phase_vggface2()
    phase_variants()
    phase_detect_parity()
    phase_detect()
    phase_eccv20()
    phase_train_parity()
    phase_train()
    phase_mesh()
    phase_demos()
    emit("done", seconds=time.time() - t_start)
    # as nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
    print(f"{card['name']}, {card['power_limit']}", flush=True)
    print(json.dumps({"kernels": [k1, epilogue]}), flush=True)
    result = {"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
