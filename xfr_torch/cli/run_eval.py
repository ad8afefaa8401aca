"""Inpainting-game evaluation + plotting CLI (port of
xfr_tpu/cli/run_eval.py; reference: eval/run_inpainting_game_eval.py).

    python -m xfr_torch.cli.run_eval --cache-dir CACHE [options]

The nets are built on the card (``create_wbnet``); without one the run
raises.  Under ``torchrun`` with ``--mesh auto`` (the default) the nets
split every blend+encode program's steps over the group's ranks: every
rank runs the whole analysis, and rank 0 writes the caches, results.csv
and the plots.  ``--mesh off`` runs each rank alone on the whole
analysis, as one process does.
"""

from __future__ import annotations

import argparse
import os
from collections import OrderedDict

import xfr_torch

human_net_labels_ = OrderedDict([
    ("vgg", "VGG"),
    ("vggface2_resnet50", "Resnet-50 (VGG Face2)"),
    ("resnet", "ResNet"),
    ("resnet_pytorch", "ResNet (PyTorch)"),
    ("resnetv4_pytorch", "ResNet v4"),
    ("resnetv6_pytorch", "ResNet v6"),
    ("resnet+compat-orig", "ResNet Fix Orig"),
    ("resnet+compat-scale1", "ResNet Fix V2"),
    ("lightcnn", "Light CNN"),
])


def main(argv=None):
    parser = argparse.ArgumentParser(
        "Script for evaluating inpainting game and plotting results. "
        "Saliency maps must already be generated (see the generate_* "
        "CLIs).")
    parser.add_argument(
        "--method", nargs="+", dest="METHOD",
        default=["meanEBP_mode=awp_v08_cuda",
                 "weighted_subtree_triplet_ebp_mode=awp,awp_v08_top32_cuda"],
        help="saliency methods to compare (filename slugs)")
    parser.add_argument("--subjects", nargs="+", dest="SUBJECT_ID",
                        type=int, default=None)
    parser.add_argument("--img", dest="IMG_BASENAME", nargs="+",
                        default=None)
    parser.add_argument("--mask", nargs="+", dest="MASK_ID", type=int,
                        default=[0, 1, 2, 4, 5, 6, 7, 8, 9])
    parser.add_argument("--reprocess", action="store_true")
    parser.add_argument("--seed", default=None, type=int)
    parser.add_argument("--output", dest="output_dir",
                        default=os.path.join(xfr_torch.xfr_root, "output",
                                             "inpainting_game"))
    parser.add_argument("--output-subdir", default=None,
                        dest="output_subdir")
    parser.add_argument("--mask-blur-sigma", dest="mask_blur_sigma",
                        default=None, type=float)
    parser.add_argument("--ignore-missing", action="store_true",
                        dest="ignore_missing_saliency_maps")
    parser.add_argument("--net", nargs="+", dest="NET",
                        default=["resnetv4_pytorch"])
    parser.add_argument("--cache-dir", dest="cache_dir", required=True)
    parser.add_argument("--saliency-dir", dest="smap_root",
                        default=xfr_torch.inpaintgame_saliencymaps_dir)
    parser.add_argument("--data-dir", dest="data_dir", default=None)
    parser.add_argument("--mesh", default="auto", choices=["auto", "off"],
                        help="auto: split the blend-embedding programs "
                             "over the torch.distributed group's ranks (at "
                             "least 2; rank 0 writes); off: each process "
                             "alone")
    args = parser.parse_args(argv)

    params = vars(args)
    params["balance_masks"] = True
    params["include_zero_saliency"] = False
    params["threshold_type"] = "percent-density"

    from xfr_torch.cli.generate_wb_saliency import resolve_mesh
    from xfr_torch.inpainting_game.analysis import make_inpaintinggame_plots
    from xfr_torch.models import create_wbnet

    mesh = resolve_mesh(args)
    net_dict = {net_name: create_wbnet(net_name).use_mesh(mesh)
                for net_name in params["NET"]}
    make_inpaintinggame_plots(net_dict=net_dict, params=params,
                              human_net_labels=human_net_labels_)


if __name__ == "__main__":
    main()
