"""The readings that a cell's correctness limits are set from, on the chip.

    python3 -m xfr_bench.readings --workload <cell> --what program \
        --seconds <s> --seeds <n> [<n> ...]
    python3 -m xfr_bench.readings --workload <cell> --what control \
        --seeds <n> [<n> ...]

``program`` runs the cell as the benchmark does (set-up, a window of
``--seconds``, the comparison) once a seed, in one process, and prints
each seed's numbers: the lower readings.  ``control`` puts the plain
reference, computed in the precision below the configuration's (TF32 for
float32, bfloat16 for float32 with TF32 allowed), in the program's place
for as many units as a run compares, and prints the same numbers against
the reference at its own precision: the upper readings.  One JSON line a
seed; a benchmark run never runs this.
"""

from __future__ import annotations

import argparse
import json
import time


def control(wl, seed, device="cuda", cfg_over=None, traffic_over=None):
    """{number: value} of the control on ``seed``."""
    from xfr_bench import harness as H

    cfg = H.config(wl["config"])
    cfg.update(cfg_over or {})
    tr = H.traffic(wl["traffic"])
    tr.update(traffic_over or {})
    K = H.kind(tr["kind"])
    units = H.pick(tr, seed, tr["check_units"])
    want = K.reference_outputs(cfg, tr, seed, device, units)
    got = K.reference_outputs(cfg, tr, seed, device, units, **K.CONTROL)
    return K.compare(got, want)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--what", choices=("program", "control"),
                    required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)

    from xfr_bench import harness as H
    from xfr_bench import run as RUN

    bench = H.benchmark(".")
    wl = H.workload(bench, args.workload)
    for seed in args.seeds:
        t0 = time.perf_counter()
        if args.what == "program":
            res, _ = RUN.run(bench, wl, seed, args.seconds, False, "cuda",
                             t0)
            numbers = {k: v["value"] for k, v in res["compared"].items()}
            extra = {"metrics": {k: v["value"] for k, v in
                                 res["metrics"].items()},
                     "attempted": res["attempted"]}
        else:
            numbers, extra = control(wl, seed), {}
        print(json.dumps({"workload": wl["name"], "what": args.what,
                          "seed": seed, "numbers": numbers, **extra,
                          "seconds": time.perf_counter() - t0}),
              flush=True)


if __name__ == "__main__":
    main()
