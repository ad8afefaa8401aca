"""Blackbox (STRise) inpainting-game saliency generation CLI (port of
xfr_tpu/cli/generate_bb_saliency.py; reference:
eval/generate_inpaintinggame_bb_saliency_maps_multigpu.py).

    python -m xfr_torch.cli.generate_bb_saliency --data-dir DATA \\
        --saliency-dir SMAPS [options]

The built-in matchers (the ResNet-101s and the VGGFace2 ResNet-50-128
and SENet-50-256) score masked probes with STRise's on-device scorer
through one BBPipeline across all jobs; any other net scores through its
embeddings and the L2 similarity on the host (reference :73-101).  The
nets are built on the card and STRise runs where its net lives; without
a card the run raises.  Jobs are sharded like the whitebox CLI's, and
--mesh works as there: under ``torchrun`` with --mesh auto (the default)
every rank runs every job, STRise splits each map's masks over the ranks
and rank 0 writes; --mesh off gives each rank its own jobs
(--shard-index/--num-shards, default the torch.distributed rank, else
shard 0 of 1).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

import xfr_torch
from xfr_torch.blackbox.strise import BUILTIN_BLACK_BOXES
from xfr_torch.cli.generate_wb_saliency import (add_common_args,
                                                build_job_table, order_jobs,
                                                resolve_mesh, resolve_shards,
                                                shard_jobs)

BUILTIN = tuple(BUILTIN_BLACK_BOXES)


def make_bb_score_fn(wb):
    """Embedding + L2-similarity scorer over host images/paths
    (reference: generate_inpaintinggame_bb_saliency_maps_multigpu.py:73-101).
    """
    def bb_fn(probes, gallery):
        def embed(images):
            if isinstance(images, (list, tuple)) and len(images) and \
                    isinstance(images[0], np.ndarray) and \
                    images[0].ndim == 3 and images[0].shape[2] == 3:
                images = [wb.convert_from_numpy(im)[0] for im in images]
            return wb.embeddings(images)

        pe = embed(probes)
        ge = embed(gallery)
        pe = pe / np.linalg.norm(pe, axis=1, keepdims=True)
        ge = ge / np.linalg.norm(ge, axis=1, keepdims=True)
        return 1.0 - 0.5 * np.linalg.norm(pe[:, None] - ge[None], axis=2)
    return bb_fn


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    add_common_args(parser)
    parser.add_argument("--net", nargs="+", dest="WB_NET",
                        default=["resnetv4_pytorch"])
    parser.add_argument("--rise-scale", type=int, default=12)
    parser.add_argument("--num-masks", type=int, default=6500)
    parser.add_argument("--prior", dest="prior_type", default="mean_ebp",
                        choices=["mean_ebp", "uniform"])
    parser.add_argument("--score-precision", default="high",
                        choices=["default", "high", "highest"],
                        help="float32 precision of the mask-scoring "
                             "encode: 'high' (the default) and 'highest' "
                             "run full float32, which keeps the mask "
                             "RANKING, the eval stage's product, at float32 "
                             "grade; 'default' allows TF32 (faster; noisier "
                             "scores)")
    args = parser.parse_args(argv)

    from xfr_torch.inpainting_game.generate import (BBPipeline,
                                                    generate_bb_smaps)
    from xfr_torch.models import create_wbnet

    data_dir = args.data_dir or xfr_torch.inpaintgame2_dir
    mesh = resolve_mesh(args)
    jobs = build_job_table(args.WB_NET, args.SUBJECT_ID, args.MASK_ID,
                           args.filter_img_nums, data_dir)
    shard_index, num_shards = resolve_shards(args, mesh)
    jobs = order_jobs(shard_jobs(jobs, shard_index, num_shards), args, mesh)
    print("worker %d/%d: %d jobs" % (shard_index, num_shards, len(jobs)))

    wbnets = {}
    net_dict = {}
    failures = []
    # one pipeline across all jobs: job k's writes overlap job k+1's
    # device scoring queue
    pipeline = BBPipeline()
    for job in jobs:
        if job["net"] not in wbnets:
            wbnets[job["net"]] = create_wbnet(job["net"], ebp_version=6)
            net_dict[(job["net"], 6)] = wbnets[job["net"]]
            if job["net"] == "resnetv4_pytorch":
                # STRise.mean_ebp_prior looks up ('resnetv4_pytorch',
                # None): alias the resident net so the default prior
                # doesn't build a SECOND full ResNet-101 per process.
                # (Other matchers keep the reference semantics: the prior
                # net is specifically resnetv4, so STRise builds it into
                # net_dict beside the matcher, once a process.)
                net_dict[("resnetv4_pytorch", None)] = wbnets[job["net"]]
        wb = wbnets[job["net"]]
        # builtin matchers get the fused on-device scorer; others keep the
        # host embeddings contract (the reference's bb CLI path)
        scorer = ((job["net"], net_dict) if job["net"] in BUILTIN
                  else make_bb_score_fn(wb))
        try:
            generate_bb_smaps(
                scorer, wb.convert_from_numpy, job["net"],
                job["img_base"], job["subject_id"], job["mask_id"],
                ebp_ver=6, overwrite=args.overwrite, device=wb.device,
                rise_scale=args.rise_scale, num_masks=args.num_masks,
                prior_type=args.prior_type, data_dir=data_dir,
                smaps_dir=args.saliency_dir, mesh=mesh, pipeline=pipeline,
                score_precision=(None if args.score_precision == "default"
                                 else args.score_precision))
        except Exception as e:
            print("Job failed: %r (%s)" % (job, e))
            failures.append((job, repr(e)))
    pipeline.drain()
    # pending-map failures are recorded under their OWN label by the
    # pipeline (a map drains during a later job's push; attributing its
    # error to that job, or aborting that job's probes, would be wrong)
    failures.extend(pipeline.failures)
    if failures:
        print("\n%d failed jobs:" % len(failures))
        for f in failures:
            print("  %r" % (f,))
        sys.exit(1)


if __name__ == "__main__":
    main()
