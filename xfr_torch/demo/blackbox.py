"""Blackbox (STRise/DISE) saliency demo on the port (counterpart of
demo/blackbox_demo.py).

    python -m xfr_torch.demo.blackbox [--custom-bb] [--subject S]
        [--num-masks N] [--prior mean_ebp|uniform] [--seed S]
        [--device cuda|cpu] [--outdir DIR]

Builds a (probe, ref, gallery) triplet, runs the full STRise pipeline and
writes the saliency overlay under the JAX demo's file name into
``--outdir`` (default: the repo's demo/ directory).  ``--custom-bb``
demonstrates the score-only external-matcher contract (the PittPatt
pattern: the scorer only sees image arrays and returns a similarity
matrix — reference blackbox.py:83-107).  The scorer keeps STRise's
default materialized-mask path (``use_pallas_blend`` off)."""

import argparse
import os

import numpy as np
import PIL.Image

import xfr_torch
from xfr_torch import show
from xfr_torch.blackbox import STRise

OUTDIR = os.path.join(xfr_torch.xfr_root, "demo")


def _subject_files(subject=0):
    """Use the reference demo triplets if present, else synthesize."""
    for root in (os.environ.get("XFR_DEMO_DATA"),
                 os.path.join(xfr_torch.xfr_root, "data")):
        if not root:
            continue
        d = os.path.join(root, "subject_%d" % subject)
        if os.path.isdir(d):
            files = sorted(os.listdir(d))
            probe = [f for f in files if "probe" in f.lower()]
            ref = [f for f in files if "ref" in f.lower()]
            gal = [f for f in files if "gallery" in f.lower()]
            if probe and ref and gal:
                return (os.path.join(d, probe[0]),
                        [os.path.join(d, f) for f in ref],
                        [os.path.join(d, f) for f in gal])
    # synthetic triplet
    rng = np.random.RandomState(subject)
    base = (rng.rand(224, 224, 3) * 60 + 60).astype(np.uint8)
    probe = base.copy()
    probe[40:90, 80:150] = 210
    ref = np.clip(probe.astype(int) + rng.randint(-10, 10, probe.shape),
                  0, 255).astype(np.uint8)
    gal = base.copy()
    gal[40:90, 80:150] = 40
    return probe, [ref], [gal]


def _patch_signature_bb(probes, gallery):
    """Example custom black_box_fn (the PittPatt contract): any function of
    raw images returning a [len(probes), len(gallery)] similarity matrix."""
    def sig(ims):
        out = []
        for im in ims:
            if isinstance(im, str):
                arr = np.asarray(PIL.Image.open(im).convert("RGB"),
                                 np.float64)
            else:
                arr = np.asarray(im, np.float64)
            out.append(arr[40:90, 80:150].mean() / 255.0)
        return np.asarray(out)

    ps, gs = sig(probes), sig(gallery)
    return 1.0 - np.abs(ps[:, None] - gs[None, :])


def make_strise(args):
    """The demo's STRise for parsed ``args`` and its file tag."""
    probe, refs, gallery = _subject_files(args.subject)
    if args.custom_bb:
        return STRise(probe=probe, refs=refs, gallery=gallery,
                      black_box_fn=_patch_signature_bb,
                      prior_type=args.prior or "uniform",
                      num_masks=args.num_masks, seed=args.seed,
                      device=args.device), "custom"
    return STRise(probe=probe, refs=refs, gallery=gallery,
                  black_box="resnetv6_pytorch",
                  prior_type=args.prior or "mean_ebp",
                  num_masks=args.num_masks, seed=args.seed,
                  device=args.device), "resnetv6"


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--subject", type=int, default=0)
    parser.add_argument("--num-masks", type=int, default=6500)
    parser.add_argument("--custom-bb", action="store_true",
                        help="use the score-only external matcher contract "
                             "instead of the built-in resnet")
    parser.add_argument("--prior", default=None,
                        choices=[None, "mean_ebp", "uniform"])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    parser.add_argument("--outdir", default=OUTDIR,
                        help="directory the overlay is written to")
    return parser.parse_args(argv)


def main(argv=None):
    """Run the demo; returns the evaluated STRise."""
    args = parse_args(argv)
    st, tag = make_strise(args)
    st.evaluate()

    overlay = show.blend_saliency_map(
        np.asarray(st.probe, np.float32) / 255.0, st.saliency_map)
    out = os.path.join(args.outdir, "blackbox_demo_subject_%d_%s.jpg"
                       % (args.subject, tag))
    PIL.Image.fromarray(np.uint8(np.clip(overlay, 0, 1) * 255)).save(out)
    print('[blackbox_demo]: saved "%s"' % out)
    print("mask_scores: %d positive of %d"
          % ((st.mask_scores > 0).sum(), len(st.mask_scores)))
    return st


if __name__ == "__main__":
    main()
