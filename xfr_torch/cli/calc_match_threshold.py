"""Match-threshold calibration CLI (port of
xfr_tpu/cli/calc_match_threshold.py; reference:
eval/calculate_net_match_threshold.py).

    python -m xfr_torch.cli.calc_match_threshold NET [--dists-dir DIR]

Aggregates the dists npz files produced by calc_subject_dists, picks the
distance threshold at FPR~=1e-4 and fits Platt scaling; prints the
wb.match_threshold / wb.platts_scaling values and writes an ROC plot.
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np

import xfr_torch
from xfr_torch.inpainting_game.dists import fit_match_threshold


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("NET", nargs="+", default=["resnetv4_pytorch"])
    parser.add_argument("--dists-dir", default=None,
                        help="directory of dists npz files (default: the "
                             "calc_subject_dists output layout)")
    args = parser.parse_args(argv)

    for net in args.NET:
        in_dir = args.dists_dir or os.path.join(
            xfr_torch.xfr_root, "output",
            "ROC_Curve_Analysis_Inpainting_Game", "Net=%s" % net)
        # a shared --dists-dir may hold several nets' dists: fit each
        # net on ITS files only (calc_subject_dists naming); fall back
        # to every npz for pre-existing per-net layouts
        npz_files = glob.glob(os.path.join(in_dir,
                                           "dists_net=%s_*.npz" % net))
        if not npz_files:
            npz_files = glob.glob(os.path.join(in_dir, "*.npz"))
        if not npz_files:
            print("Skipping net %s. Could not find any files in %s." %
                  (net, in_dir))
            print("Did you run calc_subject_dists for this net?")
            continue
        mate_dists, nonmate_dists = [], []
        for f in npz_files:
            data = np.load(f)
            mate_dists.append(data["mate_dists"])
            nonmate_dists.append(data["nonmate_dists"])
        mate_dists = np.concatenate(mate_dists)
        nonmate_dists = np.concatenate(nonmate_dists)

        thresh, alpha, fpr, tpr = fit_match_threshold(mate_dists,
                                                      nonmate_dists)
        print("\nNet %s threshold=%f, \tplatt's scaling=%f" % (net, thresh,
                                                               alpha))
        print("\nTo use, set the Whitebox object 'wb' parameters:\n")
        print("\twb.match_threshold = %f" % thresh)
        print("\twb.platts_scaling = %f\n" % alpha)

        import matplotlib
        matplotlib.use("agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots()
        ax.plot(fpr, tpr)
        ax.set(xlabel="FMR", ylabel="TMR")
        # several nets sharing one --dists-dir must not overwrite each
        # other's curve; the default per-net layout keeps the plain name
        roc_name = ("roc.png" if args.dists_dir is None or
                    len(args.NET) == 1 else "roc-%s.png" % net)
        fig.savefig(os.path.join(in_dir, roc_name))
        plt.close(fig)


if __name__ == "__main__":
    main()
