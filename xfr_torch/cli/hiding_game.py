"""Hiding-game CLI (port of xfr_tpu/cli/hiding_game.py; reference:
inpainting_game.py:272-310 HidingGame, which the reference exposes only as
a library class).

    python -m xfr_torch.cli.hiding_game --method SLUG [options]

For each generated saliency map: progressively hide the top-salient pixels
of the probe (gray fill) and record the matcher score decay vs the mate
template — the classic sanity check that salient pixels carry the match.
Writes hiding-game-{method}.csv per (net, subject, mask, image).  The net
is built on the card (``create_wbnet``); without one the run raises.
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np

import xfr_torch
from xfr_torch.inpainting_game.protocol import HidingGame
from xfr_torch.utils.image import image_loader


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--net", default="resnetv4_pytorch")
    parser.add_argument("--method", required=True,
                        help="saliency method slug to evaluate")
    parser.add_argument("--data-dir", default=None)
    parser.add_argument("--saliency-dir", default=None)
    parser.add_argument("--output", default=None)
    parser.add_argument("--delta-pct", type=float, default=5.0)
    args = parser.parse_args(argv)

    import pandas as pd

    from xfr_torch.models import create_wbnet

    data_dir = args.data_dir or xfr_torch.inpaintgame2_dir
    smaps_dir = args.saliency_dir or xfr_torch.inpaintgame_saliencymaps_dir
    out_dir = args.output or os.path.join(xfr_torch.output_dir, "hiding_game")
    os.makedirs(out_dir, exist_ok=True)

    wb = create_wbnet(args.net)
    rows = []
    pattern = os.path.join(
        smaps_dir, args.net,
        "subject_ID_*/*/*/inpainted/*-%s-saliency.npz" % args.method)
    for smap_fn in sorted(glob.glob(pattern)):
        smap = np.load(smap_fn)["saliency_map"]
        rel = os.path.relpath(smap_fn, os.path.join(smaps_dir, args.net))
        parts = rel.split(os.sep)
        subject_id = parts[0].replace("subject_ID_", "")
        base = "/".join(parts[1:-2])  # drop 'inpainted/<file>'
        mask_id = os.path.basename(smap_fn).split("-", 1)[0]
        probe_fn = os.path.join(
            data_dir, "aligned", subject_id, base, "inpainted",
            "%s_truth.png" % mask_id)
        if not os.path.exists(probe_fn):
            continue
        probe = next(iter(image_loader([probe_fn])))

        mate_embed = wb.embeddings([probe_fn])
        mate_embed = mate_embed / np.linalg.norm(mate_embed, axis=1,
                                                 keepdims=True)

        def masking_fn(masks, image):
            # hide top-salient pixels with mid-gray
            return (masks[..., None] * image[None] +
                    (1 - masks[..., None]) * 0.5)

        def scoring_fn(masked_images):
            # through the net's OWN preprocessing (resize + mean-RGB),
            # exactly like the mate embedding's file-path branch: a raw
            # [0,1] HWC stack would hit embeddings()'s already-
            # preprocessed fast path and be encoded in the wrong domain
            arrs = np.concatenate([wb.convert_from_numpy(m).cpu().numpy()
                                   for m in masked_images])
            e = wb.embeddings(arrs)
            e = e / np.linalg.norm(e, axis=1, keepdims=True)
            return 1.0 - 0.5 * np.linalg.norm(e - mate_embed, axis=1)

        hg = HidingGame(smap, probe, masking_fn, scoring_fn,
                        delta_pct=args.delta_pct)
        pcts, scores = hg.evaluate()
        for p, s in zip(pcts, scores):
            rows.append(dict(SUBJECT_ID=subject_id, MASK_ID=mask_id,
                             ORIGINAL_BASENAME=base, hidden_pct=p,
                             score=float(s)))
        print("%s: score %.4f -> %.4f over %d steps"
              % (rel, scores[0], scores[-1], len(scores)))

    out_csv = os.path.join(out_dir, "hiding-game-%s.csv" % args.method)
    pd.DataFrame(rows).to_csv(out_csv, index=False)
    print("wrote %s (%d rows)" % (out_csv, len(rows)))


if __name__ == "__main__":
    main()
