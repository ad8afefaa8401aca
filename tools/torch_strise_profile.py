#!/usr/bin/env python3
"""Where one STRise blackbox map of the xfr_torch port spends its time on
one CUDA card.

    python3 -m tools.torch_strise_profile [--precision high|none] [--out DIR]

The workload is chip_smoke.py's main path, built by its
``main_path_net`` and ``make_main_path_strise``: full-depth ResNet-101+L2
with random weights, 6,500 masks, mean-EBP prior, blur fill at 4%, scale
12, 2 elements, the fused-blend kernel.  Run it from the repo root.
After one warm-up map it times one map by the host clock (ended by a
synchronize), then runs one more under torch.profiler.  It prints one JSON line: the map's wall time without
and with the profiler, the device busy time (the sum of every kernel,
copy and set on the device; the scorer runs on one stream, so they do
not overlap), the idle share of the profiled map, and the device time
by kernel group, beside the card's name and power limit.  The table of
every kernel by device time goes to DIR/strise_profile_<precision>.txt
(default DIR: build/profiles, git-ignored).
"""

import argparse
import json
import os
import time

import numpy as np

# kernel-name fragments -> group, first match wins
GROUPS = (("fused_blend", "fused_blend (K1)"),
          ("Memcpy", "copies"), ("Memset", "copies"),
          ("conv", "convolution"), ("gemm", "convolution"),
          ("xmma", "convolution"), ("cudnn", "convolution"),
          ("sm90", "convolution"), ("sm80", "convolution"),
          ("cutlass", "convolution"), ("implicit", "convolution"),
          ("pool", "pooling"), ("reduce", "reductions"),
          ("elementwise", "elementwise"), ("vectorized", "elementwise"),
          ("copy", "elementwise"), ("cat", "elementwise"))


def group_of(name):
    low = name.lower()
    for frag, grp in GROUPS:
        if frag.lower() in low:
            return grp
    return "other"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--precision", default="high", choices=["high", "none"])
    ap.add_argument("--out", default=os.path.join("build", "profiles"))
    args = ap.parse_args()
    precision = None if args.precision == "none" else args.precision

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from xfr_torch.utils.device import card_name_and_power_limit

    if not torch.cuda.is_available():
        raise SystemExit("torch_strise_profile: no CUDA device")
    from chip_smoke import main_path_net, make_main_path_strise

    _, net_dict = main_path_net()

    def one_map(seed):
        st = make_main_path_strise(net_dict, seed, use_pallas_blend=True,
                                   score_precision=precision)
        t0 = time.time()
        smap = st.launch_evaluate()()
        torch.cuda.synchronize()
        assert np.isfinite(smap).all()
        return time.time() - t0

    one_map(0)
    wall = one_map(1)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall_prof = one_map(2)

    # device-side rows only: a CPU op's row also carries the device time
    # of the kernels it launched, and a span's (xfr.*) CUDA row is its
    # extent on the device's timeline, not a kernel
    rows = [(e.self_device_time_total, e.count, e.key)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0
            and not e.key.startswith("xfr.")]
    rows.sort(reverse=True)
    busy_s = sum(r[0] for r in rows) / 1e6
    groups = {}
    for us, count, name in rows:
        g = groups.setdefault(group_of(name), {"s": 0.0, "launches": 0})
        g["s"] += us / 1e6
        g["launches"] += count
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, f"strise_profile_{args.precision}.txt")
    card = card_name_and_power_limit()
    with open(path, "w") as f:
        f.write(f"{torch.cuda.get_device_name(0)}  score_precision="
                f"{precision}\n device_ms  count  group  kernel\n")
        for us, count, name in rows:
            f.write(f"{us / 1e3:10.3f} {count:6d}  {group_of(name):16s} "
                    f"{name[:160]}\n")
    print(json.dumps({
        "profile": "strise_map", "score_precision": precision,
        "kind": torch.cuda.get_device_name(0), **card,
        "map_s": wall, "map_s_profiled": wall_prof, "device_busy_s": busy_s,
        "idle_share": 1.0 - busy_s / wall_prof,
        "groups": dict(sorted(groups.items(), key=lambda kv: -kv[1]["s"])),
        "top": [{"ms": us / 1e3, "count": c, "name": n[:120]}
                for us, c, n in rows[:12]],
        "table": path}), flush=True)


if __name__ == "__main__":
    main()
