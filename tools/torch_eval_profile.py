#!/usr/bin/env python3
"""Where one inpainting-game evaluation group of the xfr_torch port spends
its time on one CUDA card.

    python3 -m tools.torch_eval_profile [--out DIR]

The workload is chip_smoke.py's eval phase, built by its
``whitebox_net`` and bench_torch.py's ``eval_workload``,
``launch_eval_group`` and ``drain_eval_group`` (bench.py:117-194):
full-depth ResNet-101+L2 with random weights, one probe/twin pair and
its galleries, 4 saliency maps,
101 percent-density thresholds, the 4 maps' blend+encode steps in one
TwinClsBatch program, TF32 allowed in the encode.  Run it from the repo
root.  After one warm-up group it times one group by the host clock
(ended by a synchronize), then runs one more under torch.profiler with
the mask build and blend of every step (the program's span
``xfr.eval.blend``), the steps and rows from its counters
(``xfr.eval.steps``, ``xfr.eval.rows_encoded``).

It prints one JSON line: the group's wall time without and with the
profiler, the device busy time (every kernel and copy; one stream), the
idle share of the profiled group, the steps and rows encoded, the blend's
device time, and the device time and launches by kernel group, beside the
card's name and power limit.  The table of every kernel by device time
goes to DIR/eval_profile.txt (default DIR: build/profiles, git-ignored).
"""

import argparse
import json
import os
import time

import numpy as np

from tools.torch_strise_profile import group_of


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join("build", "profiles"))
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_eval_profile: no CUDA device")
    from bench_torch import drain_eval_group, eval_workload, launch_eval_group
    from chip_smoke import eval_group_profile, whitebox_net
    from xfr_torch.utils.device import card_name_and_power_limit

    wb = whitebox_net("cuda")
    w = eval_workload(wb, np.random.RandomState(0))

    def one_group():
        torch.cuda.synchronize()
        t0 = time.time()
        drain_eval_group(launch_eval_group(wb, w, 0))
        torch.cuda.synchronize()
        return time.time() - t0

    one_group()
    wall = one_group()
    summary, rows = eval_group_profile(wb, w)
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, "eval_profile.txt")
    card = card_name_and_power_limit()
    with open(path, "w") as f:
        f.write(f"{torch.cuda.get_device_name(0)}  one eval group: 4 maps, "
                "101 thresholds, ResNet-101+L2, TF32 encode\n"
                " device_ms  count  group  kernel\n")
        for us, count, name in rows:
            f.write(f"{us / 1e3:10.3f} {count:6d}  {group_of(name):16s} "
                    f"{name[:160]}\n")
    print(json.dumps({
        "profile": "eval_group", "maps": 4,
        "kind": torch.cuda.get_device_name(0), **card,
        "group_s": wall, **summary,
        "top": [{"ms": us / 1e3, "count": c, "name": n[:120]}
                for us, c, n in rows[:12]],
        "table": path}), flush=True)


if __name__ == "__main__":
    main()
