#!/usr/bin/env python3
"""Where one whitebox 4-map mix of the xfr_torch port spends its time on
one CUDA card.

    python3 -m tools.torch_whitebox_profile [--out DIR]

The workload is chip_smoke.py's whitebox phase, built by its
``whitebox_net`` and bench_torch.py's ``whitebox_workload``,
``launch_mix`` and ``drain_mix``:
full-depth ResNet-101+L2 with random weights, B=8 probes, mean-EBP,
contrastive and truncated-contrastive under the em/2500 triplet
classifiers, weighted-subtree top-32 in norelu mode with the sweep in
bfloat16.  Run it from the repo root.  After one warm-up mix it times one
mix by the host clock (ended by a synchronize), then runs one more under
torch.profiler with named ranges (added in this process only, around the
engine's functions) for the four stages and for the event rule (K2), the
percentile-mass threshold (K3) and the sweep's select+merge (K4).

It prints one JSON line: the mix's wall time without and with the
profiler, the device busy time (the sum of every kernel, copy and set;
one stream, so they do not overlap), the idle share of the profiled mix,
the device time of the kernels launched inside each stage and inside
K2-K4 with their shares of the busy time, and the device time by kernel
group, beside the card's name and power limit.  The table of every kernel
by device time goes to DIR/whitebox_profile.txt (default DIR:
build/profiles, git-ignored).
"""

import argparse
import json
import os
import time

import numpy as np

from tools.torch_strise_profile import group_of

STAGES = (("_ebp_pooled_fn", "stage:mean_ebp"),
          ("_contrastive_both_fn", "stage:contrastive_both"),
          ("_wsebp_grad_batch_fn", "stage:ranking_pass"),
          ("_wsebp_sweep_select_scan_fn", "stage:sweep_select_merge"))
PARTS = (("interpreter", "_sweep_event_rule", "K2:event_rule_sweep"),
         ("interpreter", "_apply_event_rule", "K2:event_rule_walks"),
         ("engine", "_percentile_mass_mask", "K3:percentile_threshold"),
         ("engine", "_wsebp_select_merge", "K4:select_merge"))


def _ranged(fn, label):
    from torch.profiler import record_function

    def run(*a, **k):
        with record_function(label):
            return fn(*a, **k)

    return run


def annotate():
    """Wrap the programs of the four stages and the K2-K4 functions in named
    profiler ranges (module attributes of this process only)."""
    from xfr_torch.ebp import engine, interpreter

    mods = {"engine": engine, "interpreter": interpreter}
    for name, label in STAGES:
        build = getattr(engine.Whitebox, name)

        def wrapped(self, *a, _build=build, _label=label, **k):
            return _ranged(_build(self, *a, **k), _label)

        setattr(engine.Whitebox, name, wrapped)
    for mod, name, label in PARTS:
        setattr(mods[mod], name, _ranged(getattr(mods[mod], name), label))
    return [label for _, label in STAGES] + [label for *_, label in PARTS]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join("build", "profiles"))
    args = ap.parse_args()

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from xfr_torch.utils.device import card_name_and_power_limit

    if not torch.cuda.is_available():
        raise SystemExit("torch_whitebox_profile: no CUDA device")
    from bench_torch import drain_mix, launch_mix, whitebox_workload
    from chip_smoke import WB_B, whitebox_net

    labels = annotate()
    wb = whitebox_net("cuda")
    wb.wsebp_dtype = torch.bfloat16
    w = whitebox_workload(wb, np.random.RandomState(0), WB_B)

    def one_mix():
        t0 = time.time()
        drain_mix(wb, launch_mix(wb, w))
        torch.cuda.synchronize()
        return time.time() - t0

    one_mix()
    wall = one_mix()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall_prof = one_mix()

    ranges, rows = {}, []
    for e in prof.key_averages():
        if e.key in labels:
            if e.device_type == DeviceType.CPU:
                # device time of the kernels launched inside the range
                ranges[e.key] = {"ms": e.device_time_total / 1e3,
                                 "calls": e.count}
        elif e.device_type == DeviceType.CUDA and \
                e.self_device_time_total > 0:
            rows.append((e.self_device_time_total, e.count, e.key))
    rows.sort(reverse=True)
    busy_s = sum(r[0] for r in rows) / 1e6
    for r in ranges.values():
        r["share_of_busy"] = r["ms"] / 1e3 / busy_s
    groups = {}
    for us, count, name in rows:
        g = groups.setdefault(group_of(name), {"s": 0.0, "launches": 0})
        g["s"] += us / 1e6
        g["launches"] += count
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, "whitebox_profile.txt")
    card = card_name_and_power_limit()
    with open(path, "w") as f:
        f.write(f"{torch.cuda.get_device_name(0)}  whitebox mix, B={WB_B}, "
                "bfloat16 sweep\n device_ms  count  group  kernel\n")
        for us, count, name in rows:
            f.write(f"{us / 1e3:10.3f} {count:6d}  {group_of(name):16s} "
                    f"{name[:160]}\n")
    print(json.dumps({
        "profile": "whitebox_mix", "batch": WB_B, "maps": 4 * WB_B,
        "kind": torch.cuda.get_device_name(0), **card,
        "mix_s": wall, "mix_s_profiled": wall_prof, "device_busy_s": busy_s,
        "idle_share": 1.0 - busy_s / wall_prof,
        "kernel_launches": sum(r[1] for r in rows),
        "ranges": ranges,
        "groups": dict(sorted(groups.items(), key=lambda kv: -kv[1]["s"])),
        "top": [{"ms": us / 1e3, "count": c, "name": n[:120]}
                for us, c, n in rows[:12]],
        "table": path}), flush=True)


if __name__ == "__main__":
    main()
