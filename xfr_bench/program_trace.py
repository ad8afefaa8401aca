"""The program's own spans and counters (``xfr_torch.utils.profiling``), as
the per-layer readers and the breakdown by program step read them.

The program keeps its totals while a profiler records: in a traced run,
those of the traced window.  A program that keeps none gives None to a
reader, which then leaves its metric out.

``attribute`` puts each idle gap of a traced window down to the harness
range the host was in and, inside it, to the innermost program span
(``xfr.*``) open there, as ``<range>/<span>``; the sum of the entries of
each range is the range's idle time as ``harness.trace_summary`` reads
it.  It also gives each span's calls, seconds (the union of its intervals
in the window) and self seconds (those in which no other program span
nested in it is open).

    python3 -m xfr_bench.program_trace --workload <cell> --seed <n> \
        --seconds <s>

runs the cell's traced window as ``run.py --trace 1`` does and prints
that breakdown, the spans and the window's counters as one JSON line; a
benchmark run never runs this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from xfr_bench import harness as H

PREFIX = "xfr."


def span_seconds(name):
    """The program's host seconds in span ``name`` so far, or None."""
    try:
        from xfr_torch.utils.profiling import span_seconds as totals
    except ImportError:
        return None
    return totals().get(name)


def counter(name):
    """The program's counter ``name`` so far, or None."""
    try:
        from xfr_torch.utils.profiling import counters
    except ImportError:
        return None
    return counters().get(name)


def _idle_until(gap_a, gap_b, t):
    """Idle seconds (trace units) from the first gap's start to each of
    the times ``t``, over the sorted, disjoint gaps [gap_a, gap_b)."""
    cum = np.concatenate([[0.0], np.cumsum(gap_b - gap_a)])
    i = np.searchsorted(gap_a, t, side="right")  # gaps started by t
    last = np.maximum(i - 1, 0)
    inside = np.clip(np.minimum(t, gap_b[last]) - gap_a[last], 0, None)
    return np.where(i > 0, cum[last] + inside, 0.0)


def attribute(events, range_names):
    """{"busy_s", "idle_gaps": {name: s}, "spans": {name: {"calls", "s",
    "self_s"}}} of a Chrome trace's ``events``, in seconds."""
    win = [e for e in events if e.get("cat") == "user_annotation"
           and e.get("name") == H.WINDOW]
    if len(win) != 1:
        raise RuntimeError(f"the trace holds {len(win)} windows")
    t0, t1 = win[0]["ts"], win[0]["ts"] + win[0]["dur"]
    dev, ranges, spans = [], [], []
    for e in events:
        cat = e.get("cat")
        if cat in H.DEVICE_CATEGORIES:
            a, b = max(e["ts"], t0), min(e["ts"] + e["dur"], t1)
            if b > a:
                dev.append((a, b))
        elif cat == "user_annotation":
            a, b = max(e["ts"], t0), min(e["ts"] + e["dur"], t1)
            if e["name"] in range_names:
                ranges.append((e["name"], a, b))
            elif e["name"].startswith(PREFIX) and b > a:
                spans.append((e["name"], a, b))
    # the device's busy intervals, merged, and the gaps between them
    dev = np.asarray(sorted(dev), float).reshape(-1, 2)
    if len(dev):
        run_end = np.maximum.accumulate(dev[:, 1])
        new = np.ones(len(dev), bool)
        new[1:] = dev[1:, 0] > run_end[:-1]
        idx = np.flatnonzero(new)
        m_start = dev[idx, 0]
        m_end = np.append(run_end[idx[1:] - 1], run_end[-1])
    else:
        m_start = m_end = np.zeros(0)
    gap_a, gap_b = np.append(t0, m_end), np.append(m_start, t1)
    keep = gap_b > gap_a
    gap_a, gap_b = gap_a[keep], gap_b[keep]
    # segments between every boundary of a range or span: one label each
    cuts = {t0, t1}
    for _, a, b in ranges + spans:
        cuts.update((a, b))
    cuts = np.asarray(sorted(c for c in cuts if t0 <= c <= t1), float)
    lo, hi = cuts[:-1], cuts[1:]
    mid = (lo + hi) / 2
    idle = np.diff(_idle_until(gap_a, gap_b, cuts))
    length = hi - lo

    def covers(items):
        if not items:
            return np.zeros((len(mid), 0), bool)
        a = np.asarray([x[1] for x in items], float)
        b = np.asarray([x[2] for x in items], float)
        return (a[None] <= mid[:, None]) & (mid[:, None] < b[None])

    in_range = covers(ranges)
    in_span = covers(spans)
    span_start = np.asarray([s[1] for s in spans], float)
    inner = np.where(in_span.any(1),
                     np.where(in_span, span_start[None], -np.inf).argmax(1),
                     -1)
    gaps = {}
    for k in np.flatnonzero(idle > 0):
        r = np.flatnonzero(in_range[k])
        if not len(r):
            name = "outside_the_harness_ranges"
        else:
            name = ranges[r[0]][0]
            if inner[k] >= 0:
                name += "/" + spans[inner[k]][0]
        gaps[name] = gaps.get(name, 0.0) + idle[k] / 1e6
    table = {}
    for name in sorted({s[0] for s in spans}):
        mine = np.asarray([s[0] == name for s in spans])
        calls = int(mine.sum())
        seconds = float(length[in_span[:, mine].any(1)].sum()) / 1e6
        self_s = float(length[(inner >= 0) & mine[np.maximum(inner, 0)]]
                       .sum()) / 1e6
        table[name] = {"calls": calls, "s": seconds, "self_s": self_s}
    busy = float((m_end - m_start).sum()) / 1e6
    return {"busy_s": busy, "idle_gaps": gaps, "spans": table}


def trace_cell(wl, seed, seconds, device, cfg_over=None,
               traffic_over=None):
    """The cell ``wl``'s traced window on ``device``, as ``run.py`` runs
    it: the rate, the device's busy seconds, the idle gaps by range and
    program span, the span table and the window's counters.
    ``cfg_over``/``traffic_over`` replace sizes (the CPU tests' small
    runs)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from xfr_torch.utils import profiling

    cfg, tr = H.config(wl["config"]), H.traffic(wl["traffic"])
    cfg.update(cfg_over or {})
    tr.update(traffic_over or {})
    K = H.kind(tr["kind"])
    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                     else [])
    with profile(activities=acts):
        torch.ones(1, device=device).add_(1)
        sync()
    ranges = H.Ranges(True)
    cell = K.Cell(cfg, tr, seed, device, ranges)
    sync()
    before = profiling.counters()
    prof = profile(activities=acts)
    prof.start()
    units, window_s = H.run_window(cell, seconds, tr["trace_units"],
                                   ranges, sync)
    sync()
    prof.stop()
    cell.release()
    path = os.path.join(os.getcwd(), "build", "xfr_bench_cache",
                        f"program_trace_{os.getpid()}.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    prof.export_chrome_trace(path)
    try:
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    got = attribute(events, K.RANGES)
    after = profiling.counters()
    return {"workload": wl["name"], "seed": seed, "units": units,
            "window_s": window_s, "rate": units * K.per_unit(tr) / window_s,
            "busy_s": got["busy_s"],
            "idle_gaps": sorted(got["idle_gaps"].items(),
                                key=lambda kv: -kv[1]),
            "spans": got["spans"],
            "counters": {k: v - before.get(k, 0) for k, v in after.items()
                         if v != before.get(k, 0)}}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    root = os.getcwd()
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = os.path.join(root, "build", "xfr_bench_cache", sub)
    import torch

    if not torch.cuda.is_available():
        print("program_trace: no CUDA card", file=sys.stderr)
        return 2
    from xfr_torch.utils.device import card_name_and_power_limit

    out = trace_cell(H.workload(H.benchmark(root), args.workload),
                     args.seed, args.seconds, "cuda")
    print(json.dumps({**out, **card_name_and_power_limit()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
