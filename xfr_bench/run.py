"""Run one cell of the benchmark once and print its result line.

    python3 -m xfr_bench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``.  The cell's
set-up (weights from the seed, the program's net, the traffic's inputs,
a warm-up on the cell's own shapes) counts as ``setup_s``; then the
window runs whole units, one in flight ahead (``harness.run_window``),
for ``--seconds``, and the cell's rate is the units drained over the
window's time.  With ``--trace 1`` the window is traced by torch.profiler
(at most the traffic's ``trace_units`` units) and the line carries the
per-layer metrics, the device's busy time and a breakdown instead.

After the window the program's state is freed, the peak device memory
read, and a sample of the window's units is computed again by the plain
reference in ``xfr_bench/reference`` and compared; ``correct`` holds when
every number compared lies within the cell's limit
(``limits/<cell>.json``).  The numbers and their limits are the last
lines on standard error and the last key of the result.

Exits non-zero without a result when no card (or fewer than the cell
asks for) is present, when the program cannot be imported, and when
JAX, jaxlib, flax or the JAX package is loaded once the window has
closed.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import time


def card():
    """The first card's (name, power limit) as nvidia-smi prints them."""
    try:
        line = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()[0]
        name, limit = line.rsplit(",", 1)
        return name.strip(), limit.strip()
    except (OSError, IndexError, ValueError, subprocess.TimeoutExpired):
        return None, None


def run(bench, wl, seed, seconds, traced, device, t_start, cfg_over=None,
        traffic_over=None):
    """One run of the cell ``wl`` on ``device``.  Returns (result, the
    lines for standard error).  ``cfg_over``/``traffic_over`` replace
    sizes (the CPU tests' small runs)."""
    import torch

    from xfr_bench import harness as H

    cfg = H.config(wl["config"])
    cfg.update(cfg_over or {})
    tr = H.traffic(wl["traffic"])
    tr.update(traffic_over or {})
    K = H.kind(tr["kind"])
    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    ranges = H.Ranges(traced)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    if traced:
        # the profiler's first start in a process is slow: pay it here
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                         else [])
        with profile(activities=acts):
            torch.ones(1, device=device).add_(1)
            sync()

    cell = K.Cell(cfg, tr, seed, device, ranges)
    sync()
    setup_s = time.perf_counter() - t_start
    prof = None
    if traced:
        prof = profile(activities=acts)
        prof.start()
    units, window_s = H.run_window(
        cell, seconds, tr["trace_units"] if traced else 10 ** 9, ranges,
        sync)
    if traced:
        sync()
        prof.stop()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    out, stages = cell.out, cell.stage_seconds_at_peak()
    counters = getattr(cell, "counters", dict)()
    cell.release()
    del cell
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    per_unit = K.per_unit(tr)
    metrics = {}
    result = {"correct": False, "attempted": units * per_unit, "failed": 0}
    if traced:
        summary = H.trace_summary(prof, K.RANGES, os.path.join(
            os.getcwd(), "build", "xfr_bench_cache", "trace.json"))
        del prof
        reading = {"family": K.FAMILY, "units": units,
                   "stage_seconds": stages, "counters": counters,
                   **{k: summary[k] for k in ("window_s", "busy_s",
                                              "kernels")}}
        for m in bench["per_layer"]:
            if wl["name"] in m.get("workloads", [wl["name"]]):
                v = H.metric_reader(m["name"])(reading)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        values = {"setup_s": setup_s,
                  K.RATE: units * per_unit / window_s}
        for m in bench["end_to_end"]:
            if m["name"] in values and wl["name"] in m.get(
                    "workloads", [wl["name"]]):
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}

    picked = H.pick(tr, seed, units)
    numbers = K.compare(out, K.reference_outputs(cfg, tr, seed, device,
                                                 picked))
    correct, shown = H.verdict(numbers, H.limits(wl["name"]))
    name, power = card() if cuda else (None, None)
    result["correct"] = correct
    result["metrics"] = metrics
    result["device"] = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
        "count": wl["chips"], "memory_peak_bytes": peak,
        "power_limit": power}
    if traced:
        result["device"].update(busy_s=summary["busy_s"],
                                window_s=summary["window_s"])
        result["breakdown"] = {
            "device_ops": [[n[:64], s] for n, s in summary["device_ops"]],
            "idle_gaps": [[n, s] for n, s in summary["idle_gaps"]]}
    result["compared"] = shown
    lines = [f"xfr_bench: {wl['name']} seed {seed}: {units} units in "
             f"{window_s:.3f} s, set-up {setup_s:.3f} s, checked units "
             f"{picked}, card {name} at {power}"]
    lines += [f"{k} {v['value']!r} limit {v['limit']!r}"
              for k, v in shown.items()]
    return result, lines


def main(argv=None):
    t_start = time.perf_counter()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = os.getcwd()
    # build and kernel caches at fixed paths inside the checkout
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = os.path.join(root, "build", "xfr_bench_cache", sub)

    from xfr_bench import harness as H

    bench = H.benchmark(root)
    wl = H.workload(bench, args.workload)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < wl["chips"]:
        print(f"xfr_bench: {wl['name']} needs {wl['chips']} CUDA card(s); "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    import xfr_torch  # noqa: F401  (no program, no result)

    result, lines = run(bench, wl, args.seed, args.seconds,
                        bool(args.trace), "cuda", t_start)
    bad = H.forbidden_modules(sys.modules)
    if bad:
        print(f"xfr_bench: forbidden modules loaded: {bad}",
              file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    for line in lines:
        print(line, file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
