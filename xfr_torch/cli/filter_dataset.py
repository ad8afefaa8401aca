"""Identity-separability filtering of the inpainting-game dataset (port
of xfr_tpu/cli/filter_dataset.py; reference:
eval/filter_inpaintinggame_for_net.py).

    python -m xfr_torch.cli.filter_dataset NET [NET ...] --data-dir DATA

For each network: keep (subject, mask, image) triplets where the original
probe is closer to the mate centroid than to the inpainted-nonmate gallery
AND under the match threshold, and vice versa for the inpainted twin.
Writes filtered_masks_threshold-{net}.csv.  Excludes the symmetric-eyes
mask (4) by default, exactly the reference's mask list (:122 — its
"ear-mask" comment is stale; 3 is included there too).  The nets are
built on the card; without one the run raises.
"""

from __future__ import annotations

import argparse
import glob
import os
from collections import defaultdict

import numpy as np

import xfr_torch

INPAINTING_PATTERN_REL = ("aligned/{SUBJECT_ID}/{ORIGINAL_BASENAME}/"
                          "inpainted/{MASK_ID:05d}_out_0.png")
ORIGINAL_PATTERN_REL = ("aligned/{SUBJECT_ID}/{ORIGINAL_BASENAME}/"
                        "inpainted/00000_truth.png")
DEFAULT_MASK_IDS = [0, 1, 2, 3, 5, 7, 6, 8, 9]  # no symmetric-eyes (4)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("NET", nargs="+", help="name of networks")
    parser.add_argument("--data-dir", default=None)
    parser.add_argument("--mask-ids", nargs="+", type=int,
                        default=DEFAULT_MASK_IDS)
    parser.add_argument("--average-nonmates",
                        action=argparse.BooleanOptionalAction,
                        default=True,
                        help="score probes against the averaged inpainted"
                        " gallery (reference default); --no-average-"
                        "nonmates keeps per-image galleries and records "
                        "each probe's closest gallery image in "
                        "BestGalleryFile")
    args = parser.parse_args(argv)

    import pandas as pd
    from xfr_torch.models import create_wbnet

    data_dir = args.data_dir or xfr_torch.inpaintgame2_dir
    inpainting_pattern = os.path.join(data_dir, INPAINTING_PATTERN_REL)
    original_pattern = os.path.join(data_dir, ORIGINAL_PATTERN_REL)

    all_subj_data = []
    mask_separable = defaultdict(list)
    separability = []

    for net_name in args.NET:
        snet = create_wbnet(net_name)
        assert snet is not None
        for subj_csv_fn in sorted(glob.glob(
                os.path.join(data_dir, "subj-*.csv"))):
            subj_data = pd.read_csv(subj_csv_fn)
            if net_name == args.NET[0]:
                all_subj_data.append(subj_data)
            subj_data["ORIGINAL_BASENAME"] = [
                os.path.splitext(fn)[0]
                for fn in subj_data["ORIGINAL_FILE"]]

            probe_fns, mate_fns = [], []
            for _, row in subj_data.iterrows():
                d = row.to_dict()
                if d["TRIPLET_SET"] == "PROBE":
                    probe_fns.append(original_pattern.format(**d))
                elif d["TRIPLET_SET"] == "REF":
                    mate_fns.append(original_pattern.format(**d))
            probe_embeds = snet.embeddings(probe_fns, norm=True)
            mate_embeds = snet.embeddings(mate_fns, norm=True)
            mate_embeds = mate_embeds.mean(axis=0, keepdims=True)
            mate_embeds /= np.linalg.norm(mate_embeds, axis=1, keepdims=True)

            probe_embeds = probe_embeds[:, np.newaxis, :]
            mate_embeds = mate_embeds[:, np.newaxis, :]
            pr_dist = np.linalg.norm(probe_embeds - mate_embeds, axis=2)

            for mask_id in args.mask_ids:
                nonmate_fns, nonmate_basenames, twin_probe_fns = [], [], []
                for _, row in subj_data.iterrows():
                    d = row.to_dict()
                    d["MASK_ID"] = mask_id
                    if d["TRIPLET_SET"] == "PROBE":
                        twin_probe_fns.append(
                            inpainting_pattern.format(**d))
                    else:
                        nonmate_fns.append(inpainting_pattern.format(**d))
                        nonmate_basenames.append(d["ORIGINAL_BASENAME"])

                twin_probe_embeds = snet.embeddings(twin_probe_fns,
                                                    norm=True)
                twin_probe_embeds = twin_probe_embeds[:, np.newaxis, :]
                nonmate_embeds = snet.embeddings(nonmate_fns, norm=True)
                nonmate_embeds = nonmate_embeds[np.newaxis, :, :]
                if args.average_nonmates:
                    nonmate_embeds = nonmate_embeds.mean(axis=1,
                                                         keepdims=True)
                    nonmate_embeds /= np.linalg.norm(
                        nonmate_embeds, axis=2, keepdims=True)

                pg_dist = np.linalg.norm(probe_embeds - nonmate_embeds,
                                         axis=2)
                min_gal = pg_dist.argmin(axis=1)
                pg_dist = pg_dist.min(axis=1, keepdims=True)
                mate_correct = ((pr_dist < pg_dist) &
                                (pr_dist < snet.match_threshold))
                mate_diff = pg_dist - pr_dist

                tpg_dist = np.linalg.norm(
                    twin_probe_embeds - nonmate_embeds, axis=2)
                tpr_dist = np.linalg.norm(
                    twin_probe_embeds - mate_embeds, axis=2)
                tpg_dist = tpg_dist.min(axis=1, keepdims=True)
                twin_correct = ((tpg_dist < tpr_dist) &
                                (tpr_dist > snet.match_threshold))
                twin_diff = tpr_dist - tpg_dist

                mask_separable[mask_id].append(
                    (mate_correct, mate_diff, twin_correct, twin_diff))

                for i, (_, row) in enumerate(subj_data.loc[
                        subj_data["TRIPLET_SET"] == "PROBE"].iterrows()):
                    d = row.to_dict()
                    d["MASK_ID"] = mask_id
                    if args.average_nonmates:
                        best_gal = "average"
                    else:
                        # the probe's closest per-image gallery entry
                        # (reference :208-226; indexed by the gallery
                        # list itself rather than its fragile
                        # subj_data.iloc positional shortcut)
                        g = dict(d,
                                 ORIGINAL_BASENAME=nonmate_basenames[
                                     int(min_gal[i])])
                        best_gal = INPAINTING_PATTERN_REL.format(**g)
                    separability.append((
                        net_name, d["SUBJECT_ID"], d["ORIGINAL_FILE"],
                        d["ORIGINAL_BASENAME"], d["TRIPLET_SET"], mask_id,
                        mate_correct[i], mate_diff[i], twin_correct[i],
                        twin_diff[i],
                        ORIGINAL_PATTERN_REL.format(**d),
                        INPAINTING_PATTERN_REL.format(**d),
                        best_gal))

    all_subj_data = pd.concat(all_subj_data)
    separability = pd.DataFrame(separability, columns=[
        "NET", "SUBJECT_ID", "ORIGINAL_FILE", "ORIGINAL_BASENAME",
        "TRIPLET_SET", "MASK_ID", "CorrectlyCls", "OrigTripletSim",
        "TwinCorrectlyCls", "TwinTripletSim", "OriginalFile",
        "InpaintingFile", "BestGalleryFile"])

    def include_masks_by_thresholds(data):
        """Keep probes separable under BOTH original and twin criteria and
        attach all REF rows per accepted (subject, mask)
        (reference: filter_inpaintinggame_for_net.py:280-352)."""
        included = []
        columns = ["SUBJECT_ID", "MASK_ID", "ORIGINAL_BASENAME",
                   "OriginalFile", "InpaintingFile", "TRIPLET_SET"]
        for (subject_id, mask_id), grp in data.groupby(
                ["SUBJECT_ID", "MASK_ID"]):
            some_probes_added = False
            for _, grp2 in grp.groupby(["OriginalFile", "InpaintingFile"]):
                accept = np.all(grp2["CorrectlyCls"].apply(np.all) &
                                grp2["TwinCorrectlyCls"].apply(np.all))
                if not accept:
                    continue
                some_probes_added = True
                included.append(grp2.iloc[[0]][columns])
            if not some_probes_added:
                continue
            ref_match = all_subj_data.loc[
                (all_subj_data["SUBJECT_ID"] == subject_id) &
                (all_subj_data["TRIPLET_SET"] == "REF")]
            for (_, basename), grp2 in ref_match.groupby(
                    ["SUBJECT_ID", "ORIGINAL_BASENAME"]):
                df = grp2.iloc[[0]].copy()
                df["MASK_ID"] = mask_id
                df["ORIGINAL_BASENAME"] = basename
                df["OriginalFile"] = ORIGINAL_PATTERN_REL.format(
                    MASK_ID=mask_id, SUBJECT_ID=subject_id,
                    ORIGINAL_BASENAME=basename)
                df["InpaintingFile"] = INPAINTING_PATTERN_REL.format(
                    MASK_ID=mask_id, SUBJECT_ID=subject_id,
                    ORIGINAL_BASENAME=basename)
                included.append(df[columns])
        return pd.concat(included)

    # the reference reads ORIGINAL_BASENAME from subj csvs lazily; ensure it
    all_subj_data["ORIGINAL_BASENAME"] = [
        os.path.splitext(fn)[0] for fn in all_subj_data["ORIGINAL_FILE"]]

    for net_name, grp0 in separability.groupby("NET"):
        included = include_masks_by_thresholds(grp0)
        out = os.path.join(data_dir,
                           "filtered_masks_threshold-%s.csv" % net_name)
        included.to_csv(out, index=False)
        print(" * %s" % out)

    print("Percent correct classification (from all masks):")
    for mskid, stats in mask_separable.items():
        correct = [cc for cc, _, _, _ in stats]
        tcorrect = [tcc for _, _, tcc, _ in stats]
        disc = np.mean(np.concatenate(correct + tcorrect, axis=0))
        print("  * Mask %d: %.0f%%" % (mskid, 100 * disc))


if __name__ == "__main__":
    main()
