"""ECCV'20 paper-figure generation (port of xfr_tpu/cli/eccv20.py).

    python -m xfr_torch.cli.eccv20 --dataset DIR --figure 3 --subjects 2

Any directory of ``<subject>/<image>`` folders is a corpus; montages are
plain PIL.  Subject mining, triplet montages and the per-method saliency
overlays build figures 1-5: figures 1-2 on the ResNet-101 matcher,
figures 3-5 on LightCNN-29 v2 in its affineonly_with_prior mode, both
with ebp_version 5.  Faces are center-cropped, or with ``--use-detector``
cropped to the first box of the Faster R-CNN face detector
(``xfr_torch.detection.FasterRCNN``, on the card), with the center crop
as the fallback when it finds none.
"""

from __future__ import annotations

import argparse
import os
from collections import OrderedDict

import numpy as np
import PIL.Image
import torch

from xfr_torch import show


class FaceDirectory:
    """Minimal VGGFace2-style corpus adapter: root/<subject_id>/*.jpg."""

    def __init__(self, root, exts=(".jpg", ".jpeg", ".png")):
        self.root = root
        self._subjects = OrderedDict()
        for sid in sorted(os.listdir(root)):
            d = os.path.join(root, sid)
            if not os.path.isdir(d):
                continue
            files = sorted(f for f in os.listdir(d)
                           if f.lower().endswith(exts))
            if files:
                self._subjects[sid] = [os.path.join(d, f) for f in files]

    def subjects(self):
        return list(self._subjects)

    def subjectset(self, sid):
        return list(self._subjects[sid])

    def take_per_subject(self, n):
        return [(sid, fns[:n]) for sid, fns in self._subjects.items()]


def f_detection(imgfile, detector=None, out_size=224):
    """Crop to the first detection dilated 1.1x when a ``detector``
    callable (image array -> [[x, y, w, h, ...], ...]) is given, then
    resize the shortest side to 256 and center-crop ``out_size``."""
    im = PIL.Image.open(imgfile).convert("RGB")
    if detector is not None:
        dets = detector(np.array(im))
        if len(dets):
            x, y, w, h = dets[0][:4]
            cx, cy = x + w / 2.0, y + h / 2.0
            w, h = w * 1.1, h * 1.1
            im = im.crop((int(cx - w / 2), int(cy - h / 2),
                          int(cx + w / 2), int(cy + h / 2)))
    w, h = im.size
    scale = 256.0 / min(w, h)
    im = im.resize((int(round(w * scale)), int(round(h * scale))),
                   PIL.Image.BILINEAR)
    w, h = im.size
    left, top = (w - out_size) // 2, (h - out_size) // 2
    return im.crop((left, top, left + out_size, top + out_size))


def _encode(wb, ims):
    """Embeddings [n, D] (numpy) of PIL images through the net's
    preprocess."""
    x = torch.cat([wb.net.preprocess(im) for im in ims])
    return wb.encode(x).cpu().numpy()


def topk_nonmates(wb, dataset, topk, n_per_subject=2, detector=None):
    """Each subject's top-k nearest non-mates by the distance of their
    unit-normed template (the sum of n_per_subject embeddings)."""
    sids, embeds = [], []
    for sid, files in dataset.take_per_subject(n_per_subject):
        e = _encode(wb, [f_detection(f, detector) for f in files]).sum(axis=0)
        embeds.append(e / np.linalg.norm(e))
        sids.append(sid)
    X = np.stack(embeds)
    D = np.linalg.norm(X[:, None] - X[None], axis=2)
    out = {}
    for k, d in enumerate(D):
        order = np.argsort(d)[1:]  # exclude self
        out[sids[k]] = [sids[j] for j in order[:topk]]
    return out


def _montage(tiles, tile=112, cols=None, rows=None):
    n = len(tiles)
    cols = cols or int(np.ceil(np.sqrt(n)))
    rows = rows or int(np.ceil(n / cols))
    canvas = PIL.Image.new("RGB", (cols * (tile + 1), rows * (tile + 1)),
                           (255, 255, 255))
    for i, im in enumerate(tiles):
        if im is None:
            continue
        canvas.paste(im.resize((tile, tile)),
                     ((i % cols) * (tile + 1), (i // cols) * (tile + 1)))
    return canvas


def _blend(im, smap, gamma=0.5):
    arr = np.array(im.convert("RGB")).astype(np.float32) / 255.0
    out = show.blend_saliency_map(arr, smap, gamma=gamma)
    return PIL.Image.fromarray(np.uint8(np.clip(out, 0, 1) * 255))


# Per-method saliency overlays of one probe under the installed 2-class
# triplet classifier (row 0 mate, row 1 nonmate).

def f_saliency_whitebox_ebp(wb, im):
    P = np.zeros((1, wb.net.num_classes()), np.float32)
    P[0, 0] = 1.0
    s = wb.ebp(wb.net.preprocess(im), P)
    if np.max(s) == 255:
        s = s.astype(np.float32) / 255.0
    return _blend(im, s)


def f_saliency_whitebox_cebp(wb, im):
    s = wb.contrastive_ebp(wb.net.preprocess(im), 0, 1)
    return _blend(im, s)


def f_saliency_whitebox_tcebp(wb, im):
    s = wb.truncated_contrastive_ebp(wb.net.preprocess(im), 0, 1,
                                     percentile=20)
    return _blend(im, s)


def f_saliency_whitebox_weighted_subtree(wb, im, subtree_mode="all",
                                         topk=64, max_candidates=None):
    s, _, _, _ = wb.weighted_subtree_ebp(
        wb.net.preprocess(im), 0, 1, topk=topk, do_max_subtree=False,
        subtree_mode=subtree_mode, do_mated_similarity_gating=True,
        verbose=False, max_candidates=max_candidates)
    if np.max(s) == 255:
        s = np.float32(s) / 255.0
    return _blend(im, s)


SALIENCY_FNS = {
    "none": None,
    "ebp": f_saliency_whitebox_ebp,
    "cebp": f_saliency_whitebox_cebp,
    "tcebp": f_saliency_whitebox_tcebp,
    "weighted-subtree": f_saliency_whitebox_weighted_subtree,
}


def triplet_montage(wb, mates, nonmates, probes, outfile, f_saliency=None):
    """(mates x nonmates) saliency grid montage.

    mates/nonmates: lists of PIL images; probes: probes[i][j] is the probe
    shown for mate i vs nonmate j.  Returns (outfile, rows) where rows[i]
    is the list of rendered probe tiles for mate i (row 0 of each method
    makes the composite sub-figure 'f')."""
    X_mate = [_encode(wb, [im])[0] for im in mates]
    X_nonmate = [_encode(wb, [im])[0] for im in nonmates]

    tiles = [None] + list(nonmates)
    rows = []
    for i, im_mate in enumerate(mates):
        row = []
        for j in range(len(nonmates)):
            if f_saliency is not None:
                wb.net.set_triplet_classifier(X_mate[i], X_nonmate[j])
                row.append(f_saliency(wb, probes[i][j]))
            else:
                row.append(probes[i][j])
        rows.append(row)
        tiles.extend([im_mate] + row)
    m = _montage(tiles, cols=len(nonmates) + 1, rows=len(mates) + 1)
    m.save(outfile)
    return outfile, rows


# sub-figure letter per method, in a..e order
_METHOD_LETTERS = ("none", "ebp", "cebp", "tcebp", "weighted-subtree")


def _figure_grid(wb, figname, mates, nonmates, probes, output_dir,
                 n_subjects, methods, wsebp_mode="all",
                 wsebp_max_candidates=None):
    """Render sub-figures a..e (one per method) + the composite 'f' (the
    first mate's rendered row per method)."""
    outs = []
    first_rows = []
    for tag in methods:
        letter = "abcde"[_METHOD_LETTERS.index(tag)]
        if tag == "weighted-subtree":
            fn = lambda w, im: f_saliency_whitebox_weighted_subtree(
                w, im, subtree_mode=wsebp_mode,
                max_candidates=wsebp_max_candidates)
        else:
            fn = SALIENCY_FNS[tag]
        out = os.path.join(output_dir, "%s%s_%d.jpg"
                           % (figname, letter, n_subjects))
        out, rows = triplet_montage(wb, mates, nonmates,
                                    [list(p) for p in probes], out,
                                    f_saliency=fn)
        outs.append(out)
        first_rows.append(rows[0])
        print('[eccv20.%s]: Saving montage to "%s"' % (figname, out))

    # composite 'f': first mate repeated, one row per method
    out = os.path.join(output_dir, "%sf_%d.jpg" % (figname, n_subjects))
    tiles = [None] + list(nonmates)
    for row in first_rows:
        tiles.extend([mates[0]] + row)
    _montage(tiles, cols=len(nonmates) + 1,
             rows=len(first_rows) + 1).save(out)
    outs.append(out)
    print('[eccv20.%s]: Saving montage to "%s"' % (figname, out))
    return outs


def _select_top1(wb, dataset, n_subjects, detector, repeat_probe=False):
    """Mates x top-1 nonmates with per-column probes (a mixed-pose stand-
    in); ``repeat_probe`` repeats each row's first probe (figure 5)."""
    nonmate_map = topk_nonmates(wb, dataset, topk=max(n_subjects, 1),
                                detector=detector)
    sids = dataset.subjects()[:n_subjects]
    mates = [f_detection(dataset.subjectset(s)[0], detector) for s in sids]
    nonmate_ids = []
    for s in sids:
        for cand in nonmate_map[s]:
            if cand not in nonmate_ids:
                nonmate_ids.append(cand)
                break
    nonmates = [f_detection(dataset.subjectset(s)[0], detector)
                for s in nonmate_ids]
    probes = []
    for s in sids:
        files = dataset.subjectset(s)
        row = []
        for j in range(len(nonmate_ids)):
            idx = 1 if repeat_probe else (1 + j)
            # cycle when a subject has fewer images than probe columns
            row.append(f_detection(files[idx % len(files)], detector))
        probes.append(row)
    return mates, nonmates, probes


def _select_topk(wb, dataset, n_subjects, topk, detector):
    """Mates x the first mate's top-k nonmates, frontal (first-image)
    probes."""
    nonmate_map = topk_nonmates(wb, dataset, topk=topk, detector=detector)
    sids = dataset.subjects()[:n_subjects]
    mates = [f_detection(dataset.subjectset(s)[0], detector) for s in sids]
    nonmate_ids = nonmate_map[sids[0]][:topk]
    nonmates = [f_detection(dataset.subjectset(s)[0], detector)
                for s in nonmate_ids]
    probes = [[f_detection(dataset.subjectset(s)[0], detector)
               for _ in nonmate_ids] for s in sids]
    return mates, nonmates, probes


def figure1(wb, dataset, output_dir=".", n_subjects=4, detector=None,
            methods=_METHOD_LETTERS, wsebp_max_candidates=None):
    """Frontal mates x top-1 nonmates, mixed-pose probes, ResNet-101."""
    mates, nonmates, probes = _select_top1(wb, dataset, n_subjects,
                                           detector)
    return _figure_grid(wb, "figure1", mates, nonmates, probes,
                        output_dir, n_subjects, methods,
                        wsebp_max_candidates=wsebp_max_candidates)


def figure2(wb, dataset, output_dir=".", n_subjects=4, topk=4,
            detector=None, methods=_METHOD_LETTERS,
            wsebp_max_candidates=None):
    """One mate's top-k nonmates, frontal probes, ResNet-101."""
    mates, nonmates, probes = _select_topk(wb, dataset, n_subjects, topk,
                                           detector)
    return _figure_grid(wb, "figure2", mates, nonmates, probes,
                        output_dir, n_subjects, methods,
                        wsebp_max_candidates=wsebp_max_candidates)


def figure3(wb_lightcnn, dataset, output_dir=".", n_subjects=4,
            detector=None, methods=_METHOD_LETTERS,
            wsebp_max_candidates=None):
    """figure1 with the LightCNN-29v2 matcher."""
    mates, nonmates, probes = _select_top1(wb_lightcnn, dataset,
                                           n_subjects, detector)
    return _figure_grid(wb_lightcnn, "figure3", mates, nonmates, probes,
                        output_dir, n_subjects, methods,
                        wsebp_mode="affineonly_with_prior",
                        wsebp_max_candidates=wsebp_max_candidates)


def figure4(wb_lightcnn, dataset, output_dir=".", n_subjects=4, topk=4,
            detector=None, methods=_METHOD_LETTERS,
            wsebp_max_candidates=None):
    """figure2 with the LightCNN-29v2 matcher."""
    mates, nonmates, probes = _select_topk(wb_lightcnn, dataset,
                                           n_subjects, topk, detector)
    return _figure_grid(wb_lightcnn, "figure4", mates, nonmates, probes,
                        output_dir, n_subjects, methods,
                        wsebp_mode="affineonly_with_prior",
                        wsebp_max_candidates=wsebp_max_candidates)


def figure5(wb_lightcnn, dataset, output_dir=".", n_subjects=4,
            detector=None, methods=_METHOD_LETTERS,
            wsebp_max_candidates=None):
    """figure3 with each row's probe repeated."""
    mates, nonmates, probes = _select_top1(wb_lightcnn, dataset,
                                           n_subjects, detector,
                                           repeat_probe=True)
    return _figure_grid(wb_lightcnn, "figure5", mates, nonmates, probes,
                        output_dir, n_subjects, methods,
                        wsebp_mode="affineonly_with_prior",
                        wsebp_max_candidates=wsebp_max_candidates)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--dataset", required=True,
                        help="directory of <subject>/<image> folders")
    parser.add_argument("--net", default="resnetv4_pytorch")
    parser.add_argument("--lightcnn-net", default="lightcnn")
    parser.add_argument("--output", default=".")
    parser.add_argument("--subjects", type=int, default=4)
    parser.add_argument("--topk", type=int, default=4,
                        help="nonmate columns for figures 2/4")
    parser.add_argument("--figure", nargs="+", default=["1"],
                        choices=["1", "2", "3", "4", "5", "all"])
    parser.add_argument("--wsebp-max-candidates", type=int, default=None)
    parser.add_argument("--use-detector", action="store_true")
    args = parser.parse_args(argv)

    from xfr_torch import models

    figures = (["1", "2", "3", "4", "5"] if "all" in args.figure
               else args.figure)
    detector = None
    if args.use_detector:
        from xfr_torch import detection

        detector = detection.FasterRCNN()
    dataset = FaceDirectory(args.dataset)

    wb = (models.create_wbnet(args.net, ebp_version=5)
          if {"1", "2"} & set(figures) else None)
    wbl = (models.create_wbnet(args.lightcnn_net, ebp_version=5,
                               ebp_subtree_mode="affineonly_with_prior")
           if {"3", "4", "5"} & set(figures) else None)

    kw = dict(output_dir=args.output, n_subjects=args.subjects,
              detector=detector,
              wsebp_max_candidates=args.wsebp_max_candidates)
    outs = []
    if "1" in figures:
        outs += figure1(wb, dataset, **kw)
    if "2" in figures:
        outs += figure2(wb, dataset, topk=args.topk, **kw)
    if "3" in figures:
        outs += figure3(wbl, dataset, **kw)
    if "4" in figures:
        outs += figure4(wbl, dataset, topk=args.topk, **kw)
    if "5" in figures:
        outs += figure5(wbl, dataset, **kw)
    return outs


if __name__ == "__main__":
    main()
