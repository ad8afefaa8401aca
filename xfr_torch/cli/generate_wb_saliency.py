"""Whitebox inpainting-game saliency generation CLI (port of
xfr_tpu/cli/generate_wb_saliency.py; reference:
eval/generate_inpaintinggame_wb_saliency_maps_multigpu.py).

    python -m xfr_torch.cli.generate_wb_saliency --data-dir DATA \\
        --saliency-dir SMAPS [options]

One process drives one card; the nets are built there (``create_wbnet``)
and without a card the run raises.  Under ``torchrun`` (WORLD_SIZE > 1)
the process joins the group, NCCL with a card, each rank on the card of
its LOCAL_RANK.

--mesh auto (the default, as in the JAX CLI) then forms a 'dp' mesh over
the group's ranks: every rank walks the whole job table, the nets split
each batch's rows over the ranks and gather them, and only rank 0 writes
the maps.  --mesh off keeps one job partition per rank instead: the
(net, subject, mask, image) table is split deterministically by the
torch.distributed rank and world size (without a group, shard 0 of 1).
Explicit --shard-index/--num-shards partition in either form, keeping
the reference's shared-filesystem idempotency (--shuffle for
heterogeneous fleets).  These paths are launch-bound: a mesh divides the
rows of each program between the ranks, not the launches, so --mesh off
may be the faster form under torchrun.
"""

from __future__ import annotations

import argparse
import os
import random
import sys

import torch

import xfr_torch
from xfr_torch.parallel.distributed import initialize_from_env, process_info


def build_job_table(nets, subject_ids, mask_ids, img_nums, data_dir):
    """Enumerate (net, subject, mask, img_base) jobs from the filtered CSVs
    (reference: run_experiments, :121-243)."""
    import pandas as pd

    jobs = []
    for net_name in nets:
        ds = pd.read_csv(os.path.join(
            data_dir, "filtered_masks_threshold-{}.csv".format(net_name)))
        ds = ds.loc[ds["TRIPLET_SET"] == "PROBE"]
        if subject_ids is not None:
            ds = ds.loc[ds["SUBJECT_ID"].isin([int(s) for s in subject_ids])]
        for (sid, mask_id, base), _ in ds.groupby(
                ["SUBJECT_ID", "MASK_ID", "ORIGINAL_BASENAME"]):
            if mask_ids is not None and \
                    int(mask_id) not in [int(m) for m in mask_ids]:
                continue
            if img_nums is not None:
                num = os.path.basename(base)
                if num not in [str(i) for i in img_nums]:
                    continue
            jobs.append(dict(net=net_name, subject_id=int(sid),
                             mask_id="%05d" % int(mask_id), img_base=base))
    return jobs


def shard_jobs(jobs, shard_index, num_shards):
    return [j for i, j in enumerate(jobs) if i % num_shards == shard_index]


def add_common_args(parser):
    parser.add_argument("--subjects", nargs="+", dest="SUBJECT_ID",
                        default=None,
                        help="restrict processing to specific subjects")
    parser.add_argument("--img-num", nargs="*", dest="filter_img_nums",
                        default=None,
                        help="restrict processing to specific image numbers")
    parser.add_argument("--mask", nargs="+", dest="MASK_ID",
                        default=["{:05}".format(m) for m in range(10)],
                        help="restrict processing to specific masks, "
                             "zero padded")
    parser.add_argument("--overwrite", action="store_true",
                        help="force recalculation of saliency maps")
    parser.add_argument("--shuffle", action="store_true",
                        help="randomize job order (multi-machine runs over "
                             "a shared filesystem)")
    parser.add_argument("--shard-index", type=int, default=None,
                        help="this worker's shard (default: the "
                             "torch.distributed rank, else 0)")
    parser.add_argument("--num-shards", type=int, default=None,
                        help="total workers (default: the "
                             "torch.distributed world size, else 1)")
    parser.add_argument("--data-dir", default=None,
                        help="inpainting-game dataset root")
    parser.add_argument("--saliency-dir", default=None,
                        help="saliency map output root")
    parser.add_argument("--mesh", default="auto", choices=["auto", "off"],
                        help="auto: a 'dp' mesh over the torch.distributed "
                             "group's ranks when it has at least 2 (every "
                             "rank runs every job on its rows; rank 0 "
                             "writes); off: one job shard per rank")


def resolve_mesh(args):
    """The run's device mesh: join a ``torchrun`` group if one is
    described, then with --mesh auto a 'dp' mesh over its ranks (None
    with fewer than 2)."""
    from xfr_torch.parallel.mesh import auto_mesh

    initialize_from_env()
    return auto_mesh() if args.mesh == "auto" else None


def resolve_shards(args, mesh=None):
    """(shard index, shard count) from --shard-index/--num-shards, else
    (0, 1) under an active mesh (every rank walks the whole job table, so
    the ranks' collectives pair the same jobs), else the torch.distributed
    rank and world size (a ``torchrun`` launch), else (0, 1)."""
    if args.shard_index is not None or args.num_shards is not None:
        return args.shard_index or 0, args.num_shards or 1
    if mesh is not None:
        return 0, 1
    return process_info()


def order_jobs(jobs, args, mesh):
    """The shard's jobs, shuffled with --shuffle: under a mesh with a
    shared seed, so that every rank takes them in one order."""
    if args.shuffle:
        (random.Random(0) if mesh is not None else random).shuffle(jobs)
    return jobs


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    add_common_args(parser)
    parser.add_argument("--net", nargs="+", dest="WB_NET",
                        default=["resnetv4_pytorch"])
    parser.add_argument("--method", nargs="+", dest="METHOD",
                        default=["meanEBP", "contrastive",
                                 "weighted-subtree"])
    parser.add_argument("--ebp-ver", nargs="+", dest="EBP_VER",
                        default=["6"], help="EBP version (leave as default)")
    parser.add_argument("--init-ebp-subtree-mode", nargs="+",
                        dest="INIT_EBP_SUBTREE_MODE", default=[None],
                        help="subtree mode for the Whitebox constructor")
    parser.add_argument("--subtree-mode-weighted", nargs="+",
                        dest="EBP_SUBTREE_MODE_WEIGHTED", default=[None],
                        help="subtree mode for weighted_subtree_ebp")
    parser.add_argument("--wsebp-max-candidates", type=int, default=None,
                        help="cap on weighted-subtree candidate layers "
                             "(None = all, exact reference semantics)")
    parser.add_argument("--batch-size", type=int, default=8,
                        help="probe batch for the batched generation "
                             "pipeline (0 = serial per-job reference flow)")
    parser.add_argument("--compute-dtype", default="float32",
                        choices=["float32", "bfloat16"],
                        help="EBP compute dtype; bfloat16 perturbs the "
                             "contrastive maps (see the Whitebox "
                             "docstring)")
    parser.add_argument("--contrastive-dtype", default=None,
                        choices=["float32", "bfloat16"],
                        help="dtype of the contrastive/truncated backward "
                             "passes (default float32: bfloat16 rounding "
                             "dominates the near-equal-map difference, so "
                             "--compute-dtype bfloat16 keeps these float32)")
    parser.add_argument("--wsebp-dtype", default="bfloat16",
                        choices=["float32", "bfloat16"],
                        help="dtype of the weighted-subtree candidate "
                             "sweep only (default bfloat16, quality-gated "
                             "against float32 in "
                             "tests/test_torch_whitebox.py; the contrastive "
                             "and mean paths keep --compute-dtype)")
    args = parser.parse_args(argv)

    from xfr_torch.inpainting_game.generate import (generate_wb_smaps,
                                                    generate_wb_smaps_batched)
    from xfr_torch.models import create_wbnet

    data_dir = args.data_dir or xfr_torch.inpaintgame2_dir
    mesh = resolve_mesh(args)
    jobs = build_job_table(args.WB_NET, args.SUBJECT_ID, args.MASK_ID,
                           args.filter_img_nums, data_dir)
    shard_index, num_shards = resolve_shards(args, mesh)
    jobs = order_jobs(shard_jobs(jobs, shard_index, num_shards), args, mesh)
    print("worker %d/%d: %d jobs" % (shard_index, num_shards, len(jobs)))

    ebp_ver = int(args.EBP_VER[0])
    init_mode = args.INIT_EBP_SUBTREE_MODE[0]
    weighted_mode = args.EBP_SUBTREE_MODE_WEIGHTED[0]

    def make_wb(net_name):
        wb = create_wbnet(net_name, ebp_version=ebp_ver,
                          ebp_subtree_mode=init_mode)
        wb.compute_dtype = getattr(torch, args.compute_dtype)
        wb.wsebp_dtype = getattr(torch, args.wsebp_dtype)
        wb.contrastive_dtype = getattr(torch,
                                       args.contrastive_dtype or "float32")
        return wb.use_mesh(mesh)

    if args.batch_size and args.batch_size > 0:
        # batched pipeline: the methods batch across jobs
        failures = []
        # in job order (a set's order varies between processes, and the
        # ranks of a mesh must take the nets in one order)
        for net_name in dict.fromkeys(j["net"] for j in jobs):
            wb = make_wb(net_name)
            net_jobs = [(j["subject_id"], j["mask_id"], j["img_base"])
                        for j in jobs if j["net"] == net_name]
            for method in args.METHOD:
                try:
                    generate_wb_smaps_batched(
                        wb, net_name, net_jobs,
                        subtree_mode_weighted=(weighted_mode or
                                               wb.ebp_subtree_mode()),
                        ebp_ver=ebp_ver, overwrite=args.overwrite,
                        method=method,
                        wsebp_max_candidates=args.wsebp_max_candidates,
                        data_dir=data_dir, smaps_dir=args.saliency_dir,
                        batch_size=args.batch_size)
                except Exception as e:
                    # keep going like the serial branch: a failed (net,
                    # method) pass must not drop the remaining methods/
                    # nets of this shard (completed maps are on disk)
                    print("Batched pass failed: net=%s method=%s (%s)"
                          % (net_name, method, e))
                    failures.append((net_name, method, repr(e)))
        if failures:
            print("\n%d failed batched passes:" % len(failures))
            for f in failures:
                print("  %r" % (f,))
            sys.exit(1)
        return

    wbnets = {}
    failures = []
    for job in jobs:
        if job["net"] not in wbnets:
            wbnets[job["net"]] = make_wb(job["net"])
        wb = wbnets[job["net"]]
        wmode = weighted_mode or wb.ebp_subtree_mode()
        for method in args.METHOD:
            try:
                generate_wb_smaps(
                    wb, job["net"], job["img_base"], job["subject_id"],
                    job["mask_id"], subtree_mode_weighted=wmode,
                    ebp_ver=ebp_ver, overwrite=args.overwrite,
                    method=method,
                    wsebp_max_candidates=args.wsebp_max_candidates,
                    data_dir=data_dir, smaps_dir=args.saliency_dir)
            except Exception as e:  # keep going like the reference pool
                print("Job failed: %r (%s)" % (job, e))
                failures.append((job, method, repr(e)))
    if failures:
        print("\n%d failed jobs:" % len(failures))
        for f in failures:
            print("  %r" % (f,))
        sys.exit(1)


if __name__ == "__main__":
    main()
