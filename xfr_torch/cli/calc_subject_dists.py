"""IJB-C mate/non-mate distance CLI (port of
xfr_tpu/cli/calc_subject_dists.py; reference:
eval/calculate_subject_dists_inpaintinggame.py).

    IJBC_PATH=IJBC python -m xfr_torch.cli.calc_subject_dists [options]

Runs calc_mate_nonmate_dists over seeds (sharded across workers with
--shard-index/--num-shards, default the torch.distributed rank, else
shard 0 of 1, instead of the
reference's GPU pool) and writes dists npz files for
calc_match_threshold.  The nets are built on the card; without one the
run raises.
"""

from __future__ import annotations

import argparse
import os
import warnings

import numpy as np

import xfr_torch
from xfr_torch.cli.generate_wb_saliency import resolve_shards


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--net", nargs="+", dest="NET",
                        default=["resnetv4_pytorch"])
    parser.add_argument("--seeds", nargs="+", type=int,
                        default=list(range(10)))
    parser.add_argument("--num-subjects", type=int, default=20)
    parser.add_argument("--num-nonmates", type=int, default=64)
    parser.add_argument("--output", dest="output_dir", default=None)
    parser.add_argument("--shard-index", type=int, default=None)
    parser.add_argument("--num-shards", type=int, default=None)
    args = parser.parse_args(argv)

    if "IJBC_PATH" in os.environ:
        ijbc_path = os.environ["IJBC_PATH"]
    else:
        ijbc_path = "/proj/janus3/data/Janus_CS4/IJB-C/"
        warnings.warn('IJBC_PATH environment variable is not set. Using '
                      '"%s"' % ijbc_path)

    from xfr_torch.models import create_wbnet
    from xfr_torch.inpainting_game.dists import calc_mate_nonmate_dists

    shard_index, num_shards = resolve_shards(args)
    jobs = [(net, seed) for net in args.NET for seed in args.seeds]
    jobs = [j for i, j in enumerate(jobs) if i % num_shards == shard_index]

    nets = {}
    for net_name, seed in jobs:
        if net_name not in nets:
            nets[net_name] = create_wbnet(net_name)
        out_dir = args.output_dir or os.path.join(
            xfr_torch.xfr_root, "output",
            "ROC_Curve_Analysis_Inpainting_Game", "Net=%s" % net_name)
        os.makedirs(out_dir, exist_ok=True)
        fn = os.path.join(out_dir,
                          "dists_net=%s_seed=%d.npz" % (net_name, seed))
        if os.path.exists(fn):
            print("skipping existing %s" % fn)
            continue
        mate_dists, nonmate_dists = calc_mate_nonmate_dists(
            nets[net_name], num_subjects=args.num_subjects, seed=seed,
            output_dir=out_dir, ijbc_path=ijbc_path,
            num_nonmates=args.num_nonmates)
        np.savez(fn, mate_dists=mate_dists, nonmate_dists=nonmate_dists)
        print("wrote %s" % fn)


if __name__ == "__main__":
    main()
