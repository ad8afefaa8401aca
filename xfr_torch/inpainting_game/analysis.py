"""Inpainting-game analysis + plotting (port of
xfr_tpu/inpainting_game/analysis.py; reference:
python/xfr/inpainting_game/plot_inpainting_game.py).

Two cached passes per (net, subject, mask, probe, method): the twin
classification curve and the IoU curve, aggregated into "classified as
inpainted non-mate vs false-alarm-rate" plots, per-mask-region plots, and a
results.csv with cls@FAR 1e-2 / 5e-2 — the headline statistics of the
benchmark.  CSV schemas, cache filename slugs and plot filenames match the
JAX package's, so results interoperate.  The twin classification runs on
the net's device (the card unless the caller built the net on the CPU);
the IoU curves, thresholds and tables stay numpy on the host.  pandas,
imageio and matplotlib are imported where the file I/O needs them.

Under a device mesh (a net of ``net_dict`` with ``use_mesh``), every rank
runs the same analysis: the ranks agree on each twin-classification
cache hit (an all-reduce, so a launch whose finish gathers runs on every
rank or on none), and only the first rank writes caches, maps, tables
and plots.
"""

from __future__ import annotations

import glob
import itertools
import os
import pickle
import re
from collections import OrderedDict, defaultdict
from pathlib import Path

import numpy as np

import xfr_torch
from xfr_torch import show
from xfr_torch import inpainting_game as inpaintgame
from xfr_torch.parallel.distributed import writes
from xfr_torch.utils import cache_npz, cache_npz_launch
from xfr_torch.utils.image import gaussian, resize

# Facial regions by MASK_ID (reference: plot_inpainting_game.py:44-89).
regions = OrderedDict([
    ("jaw+cheek", (["chin", "jawline", "cheek"],
                   {"faceside": "symmetric", "dilate_radius": 3})),
    ("mouth", (["lips"], {"faceside": "symmetric", "dilate_radius": 9})),
    ("nose", (["nasal base", "nasal tip", "nasal body"],
              {"faceside": "symmetric", "dilate_radius": 9})),
    ("ear", (["ear"], {"faceside": "symmetric", "dilate_radius": 15})),
    ("eye", (["eye"], {"faceside": "symmetric", "dilate_radius": 5})),
    ("eyebrow", (["eyebrow"], {"faceside": "symmetric",
                               "dilate_radius": 5})),
    ("left-face", (["eye", "eyebrow", "cheek", "jawline"],
                   {"faceside": "left", "dilate_radius": 9})),
    ("right-face", (["eye", "eyebrow", "cheek", "jawline"],
                    {"faceside": "right", "dilate_radius": 9})),
    ("left-eye", (["eye"], {"faceside": "left", "dilate_radius": 5})),
    ("right-eye", (["eye"], {"faceside": "right", "dilate_radius": 5})),
])

regions_human_labels = {
    0: "Jaw+Cheek", 1: "Mouth", 2: "Nose", 3: "Ears", 4: "Eyes",
    5: "Eyebrows", 6: "Left face", 7: "Right face", 8: "Left eye",
    9: "Right eye", 167: "L/R Face", 189: "L/R Eye",
}

human_net_labels_ = OrderedDict([
    ("vgg", "VGG"),
    ("resnet", "ResNet"),
    ("resnet_pytorch", "ResNet (PyTorch)"),
    ("resnetv4_pytorch", "ResNet v4"),
    ("resnetv6_pytorch", "ResNet v6"),
    ("lightcnn", "LightCNN"),
    ("vggface2_resnet50", "VGGFace2 ResNet-50"),
    ("resnet+compat-orig", "ResNet Fix Orig"),
    ("resnet+compat-scale1", "ResNet Fix V2"),
])

# Method slug -> human label(s) (reference: plot_inpainting_game.py:368-416).
human_labels_all = [
    ("diffOrigInpaint", "Groundtruth"),
    ("inpaintingMask", "Groundtruth - Inpainting Mask"),
    ("meanEBP", "Mean EBP"),
    ("bbox-rise", "DISE"),
    ("bb-bmay2rise", "Blackbox RISE"),
    ("meanEBP_VGG", "VGG Mean EBP"),
    ("meanEBP_ResNet", "ResNet Mean EBP (Caffe)"),
    ("weighted_subtree_triplet_ebp", "Subtree EBP"),
    ("contrastive_triplet_ebp", "Contrastive EBP"),
    ("trunc_contrastive_triplet_ebp", "Truncated cEBP"),
]


def skip_combination(net, method, suffix_aggr):
    """Legacy VGG method exclusions (plot_inpainting_game.py:357-366)."""
    if net == "vgg" and method in ("tlEBPreluLayer", "tlEBPposReflect",
                                   "tlEBPnegReflect", "meanEBP_VGG"):
        return True
    return False


def _crossnet_method_remap(d, method):
    """meanEBP_VGG / meanEBP_ResNet are cross-net pseudo-methods: a
    comparison row that reads ANOTHER net's plain meanEBP saliency maps
    while scoring under the current net's embeddings (reference:
    plot_inpainting_game.py:983-987 twin-cls and :1084-1088 IoU).  Remap
    the path-format dict's NET/METHOD before any filename is built."""
    if method == "meanEBP_VGG":
        d["NET"] = "vgg"
        d["METHOD"] = "meanEBP"
    elif method == "meanEBP_ResNet":
        d["NET"] = "resnet+compat-scale1"
        d["METHOD"] = "meanEBP"


def get_base_methods(methods):
    base = [m.split("_scale_")[0] for m in methods]
    base = [m.split("_trunc")[0] for m in base]
    for elem in ("-1elem_", "-2elem_", "-4elem_"):
        base = [m.split(elem)[0] for m in base]
    base = [m.split("_reluLayer")[0] for m in base]
    base = [m.split("_mode")[0] for m in base]
    base = [m.split("_v")[0] for m in base]
    return base


def get_method_labels(methods, lookup):
    labels = []
    for base in get_base_methods(methods):
        labels.append(lookup.get(base, base))
    return labels


def backupMethods(method, inpainted_region, orig_imT, inp_imT, error):
    """Groundtruth pseudo-methods (plot_inpainting_game.py:439-466)."""
    if method == "diffOrigInpaint":
        smap = np.sum(np.abs(orig_imT - inp_imT), axis=0)
        smap_blur = gaussian(smap, 0.02 * max(smap.shape[:2]))
        smap_blur[smap == 0] = 0
        smap = smap_blur
        smap /= smap.sum()
    elif method.split("+")[0] == "inpaintingMask":
        smap0 = np.mean(np.abs(orig_imT - inp_imT), axis=0)
        smap = inpainted_region.astype(float)
        smap = np.maximum(smap, smap0).astype(bool).astype(float)
        smap = gaussian(smap, 0.02 * max(smap.shape[:2]))
        if method == "inpaintingMask+noise":
            noise = np.random.randn(*smap.shape) * 0.5
            smap = np.abs(smap + noise)
        smap /= smap.sum()
    else:
        raise error
    return smap


def method_label_and_idx(method, methods, human_net_labels, net=None):
    """Parse a method slug back into a display label + color index
    (plot_inpainting_game.py:620-765)."""
    base_methods = get_base_methods(methods)
    human_labels = [(t[0], t[1], t[1] if len(t) == 2 else t[2])
                    for t in human_labels_all
                    if t[0] in methods or t[0] in base_methods]
    lookup = OrderedDict((k, l) for k, l, _ in human_labels)
    slookup = OrderedDict((k, s) for k, _, s in human_labels)

    try:
        method_idx = int(np.where([m == method for m in methods])[0][0])
        label = get_method_labels([method], lookup)[0]
        slabel = get_method_labels([method], slookup)[0]
        paren, sparen = [], []

        if re.search("pytorch-", method):
            paren.append("PyTorch/WIP")
            sparen.append("PyTorch/WIP")
        m = re.search("_scale_([0-9+]*[0-9])", method)
        if m and m.group(1) != "12":
            paren.append("Scale " + m.group(1))
            sparen.append("Scale " + m.group(1))
        m = re.search("-([0-9]+)elem", method)
        if m and int(m.group(1)) > 1:
            paren.append(m.group(1) + " Elems")
        m = re.search("_(blur)=([0-9]+)", method)
        if m:
            paren.append("Blur fill")
            if m.group(2) != "4":
                paren.append("Sigma " + m.group(2) + "%")
        m = re.search("_(gray)", method)
        if m:
            paren.append("Gray fill")
            sparen.append("Gray fill")
        if re.search("_reluLayer", method):
            paren.append("ReLU")
        m = re.search("_top([0-9]+)", method)
        if m:
            paren.append("Top %d" % int(m.group(1)))
        m = re.search("_v([0-9]+)", method)
        if m:
            paren.append("V%d" % int(m.group(1)))
        m = re.search("_pct([0-9]+)", method)
        if m:
            paren.append("Thresh %d%%" % int(m.group(1)))
        m = re.search("_trunc([0-9]+)", method)
        if m:
            paren.append("Trunc " + m.group(1) + "% Pos")
            sparen.append("Truncated")
        if paren:
            label = "%s (%s)" % (label, ", ".join(paren))
        if sparen:
            slabel = "%s (%s)" % (slabel, ", ".join(sparen))
    except KeyError:
        label = method
        slabel = method
    # _method_color plots method i as f"C{i+1}" (C0 is reserved for the
    # ground-truth line) and matplotlib's tab10 cycle wraps at C10 — so
    # 9 methods is the hard cap, not 10 (method_idx 9 would render as
    # C10 == C0 and masquerade as ground truth)
    assert method_idx < 9  # limited by the color map used
    return label, method_idx, slabel


def tickformatter(x, pos):
    return "%d%%" % x if float.is_integer(float(x)) else ""


def _pooled(grp, col):
    """Sum a per-row count column (scalar or T-vector curve) across the
    group's rows: the sweep counts pool across images/masks before any
    rate is formed."""
    return np.stack(grp[col].values.tolist()).sum(axis=0)


def _method_color(method_idx):
    # C0 is reserved for the ground-truth/reference line in the figures
    return "C%d" % (method_idx + 1)


def _finish_rate_axes(ax, title, xlabel, ylabel, **extra):
    """Shared cosmetics of the rate-vs-rate panels: whole-percent tick
    labels, dotted grid, in-axes legend."""
    import matplotlib.pyplot as plt

    if title is not None:
        ax.set_title(title)
    if ylabel is not None:
        ax.set(ylabel=ylabel)
    ax.set(xlabel=xlabel, **extra)
    ax.grid(which="both", linestyle=":")
    ax.xaxis.set_major_formatter(plt.FuncFormatter(tickformatter))
    ax.yaxis.set_major_formatter(plt.FuncFormatter(tickformatter))
    ax.legend()


def avg_class_prob(grp, classifyCol, balance_masks):
    """Mean classification curve over the group's rows.

    With ``balance_masks`` every inpainting mask contributes equally no
    matter how many probe images carry it: average within each MASK_ID
    first, then across masks (the benchmark's mask-balancing
    convention; results parity pinned by tests/test_plot_helpers.py and
    the e2e results.csv tests)."""
    if not balance_masks:
        return np.stack(grp[classifyCol].values).mean(axis=0)
    per_mask = grp.groupby("MASK_ID")[classifyCol].apply(
        lambda curves: np.stack(curves.values.tolist()).mean(axis=0))
    return np.stack(per_mask.values).mean(axis=0)


def classification_at_far(fpr, curve, targets=(1e-2, 5e-2)):
    """Read the classification curve off at target false-alarm rates —
    the headline numbers of results.csv.  The threshold sweep samples
    FAR on a grid, so each target generally falls between two samples;
    interpolate between the two nearest with inverse-distance weights
    (a target landing exactly on a sample gets weight ~1 on it)."""
    fpr = np.asarray(fpr, np.float64)
    out = {}
    for target in targets:
        dist = np.abs(fpr - target)
        nearest = np.argsort(dist)[:2]
        w = 1 / (dist[nearest] + 1e-9)
        w = w / np.sum(w)
        out[target] = float(np.sum(w * curve[nearest]))
    return out


def plot_roc_curve(ax, grp, hnet, label, method_idx, balance_masks,
                   leftmost=True, classifyCol="CLS_AS_TWIN"):
    """One method's pooled twin-detector ROC across the threshold sweep
    (counts pooled over the group's rows, then rated)."""
    fpos, neg = _pooled(grp, "FALSE_POS"), _pooled(grp, "NEG")
    tpos, pos = _pooled(grp, "TRUE_POS"), _pooled(grp, "POS")
    ax.plot(100 * fpos / neg, 100 * tpos / pos,
            color=_method_color(method_idx), label=label)
    _finish_rate_axes(
        ax, hnet, "False Positive Rate\n(1-Specificity)",
        "True Positive Rate\n(Sensitivity)" if leftmost else None)


def plot_cls_vs_fpr(ax, grp, hnet, label, method_idx, balance_masks,
                    leftmost=True, classifyCol="CLS_AS_TWIN"):
    """One method's classification-vs-false-alarm panel; returns the
    plotted line and its cls@FAR readouts (the results.csv numbers)."""
    curve = avg_class_prob(grp, classifyCol, balance_masks)
    fpr = _pooled(grp, "FALSE_POS").astype(np.float64) \
        / _pooled(grp, "NEG")
    cls_at_fpr = classification_at_far(fpr, curve)
    line, = ax.plot(100 * fpr, 100 * curve,
                    color=_method_color(method_idx), label=label,
                    linewidth=2)
    _finish_rate_axes(
        ax, hnet, "False Alarm Rate",
        "Classified as Inpainted Non-mate" if leftmost else None,
        xscale="symlog", xlim=(0, 100))
    return line, cls_at_fpr


def overlap_mask(smap, img, gt_mask, pred_mask):
    rgb = img / max(0.0001, img.max()) * 0.4
    rgb[gt_mask] = np.array([0.6, 0.6, 0.6])
    rgb[pred_mask & gt_mask] = np.array([0, 1, 0])
    rgb[pred_mask & np.invert(gt_mask)] = np.array([1, 0, 0])
    return rgb


def dataset_stats(nonmate_classification, inpainting_v2_data, output_dir):
    """Per-net/mask/method triplet-count report + the per-net
    ``datasets-stats-{net}.png`` bar figure (the stats tail of the
    reference's make_inpaintinggame_plots, plot_inpainting_game.py:
    171-219).  Bars are in mask order (the reference hardcodes a
    6-position swap [0,1,2,3,5,4] that crashes on any other mask count;
    ordering is cosmetic)."""
    import matplotlib
    matplotlib.use("agg")
    import matplotlib.pyplot as plt

    for base_net, net_inp in inpainting_v2_data.groupby("NET"):
        probes = net_inp.loc[net_inp["TRIPLET_SET"] == "PROBE"]
        print("\n%s has %d inpainted triplet examples from %d subjects." %
              (base_net, len(probes), len(net_inp["SUBJECT_ID"].unique())))
        for mask_id, msk_grp in probes.groupby("MASK_ID"):
            print("\tmask %s contains %d images from %d subjects." %
                  (mask_id, len(msk_grp),
                   len(msk_grp["SUBJECT_ID"].unique())))

    num_triplets = {}
    for (base_net, method), mdata in nonmate_classification.groupby(
            ["NET", "METHOD"]):
        print("\n%s + %s has %d inpainted triplet examples from %d "
              "subjects." % (base_net, method, len(mdata),
                             len(mdata["SUBJECT_ID"].unique())))
        counts = num_triplets.setdefault(base_net, OrderedDict())
        for mask_id, msk_grp in mdata.groupby("MASK_ID"):
            print("\tmask %s contains %d examples from %d subjects." %
                  (mask_id, len(msk_grp),
                   len(msk_grp["SUBJECT_ID"].unique())))
            # all methods share the triplet set for a net
            counts[mask_id] = len(msk_grp)

    for base_net, counts in num_triplets.items():
        fig, ax = plt.subplots(1, 1, figsize=(6, 4), squeeze=True)
        x = np.arange(len(counts))
        ax.bar(x, list(counts.values()))
        ax.set_xticks(x)
        ax.set_xticklabels(
            [regions_human_labels.get(k, str(k)) for k in counts],
            rotation=50)
        fig.subplots_adjust(top=1, bottom=0.5, left=0.2, right=0.98)
        show.savefig("datasets-stats-%s.png" % base_net, fig,
                     output_dir=output_dir)
        plt.close(fig)


def export_mask_overlaps(nonmate_classification, params, max_rows=40):
    """Identity-flip overlay PNGs (the maskoverlap pass of the
    reference's make_inpaintinggame_plots, plot_inpainting_game.py:
    221-287): for each (net, merged-mask, method) group render up to
    ``max_rows`` probes with the ground-truth inpainting region gray and
    the saliency's top-k pixel set — k at the threshold where the probe
    FIRST classifies as the inpainted twin — green where it hits the
    region and red where it false-alarms, written to
    ``{out}/{NET}/mask-{id}/{METHOD}/{basename}-{orig}-idflip.png``.

    Unlike the reference, the smap path applies the cross-net pseudo-
    method remap and a missing map skips the row under
    ``ignore_missing_saliency_maps`` instead of crashing the export."""
    import imageio.v2 as imageio

    from xfr_torch.utils.image import center_crop

    output_dir = params["output_dir"]
    if params.get("output_subdir"):
        output_dir = os.path.join(output_dir, params["output_subdir"])
    data_dir = params.get("data_dir") or xfr_torch.inpaintgame2_dir
    smap_root = "%s{SUFFIX_AGGR}/" % params["smap_root"]
    smap_pattern = os.path.join(
        smap_root, "{NET}/subject_ID_{SUBJECT_ID}/{ORIGINAL_BASENAME}/"
        "inpainted/{ORIG_MASK_ID:05d}-{METHOD}-saliency.npz")
    orig_pattern = os.path.join(
        data_dir, "aligned/{SUBJECT_ID}/{ORIGINAL_BASENAME}/"
        "inpainted/{ORIG_MASK_ID:05d}_truth.png")
    mask_pattern = os.path.join(
        data_dir, "aligned/{SUBJECT_ID}/{ORIGINAL_BASENAME}/masks/"
        "{ORIG_MASK_ID:05d}.png")

    written = []
    for keys, grp in nonmate_classification.groupby(
            ["NET", "MASK_ID", "METHOD"]):
        for row_num, (_, row) in enumerate(grp.iterrows()):
            if row_num >= max_rows:
                break
            cls = np.asarray(row["CLS_AS_TWIN"])
            if cls[-1] != 1:
                # never stably flips: show the full-sweep endpoint
                first_correct = len(cls) - 1
            else:
                first_correct = int(np.min(np.where(cls == 1)[0]))
            n_pixels = int((np.asarray(row["TRUE_POS"]) +
                            np.asarray(row["FALSE_POS"]))[first_correct])
            d = row.to_dict()
            _crossnet_method_remap(d, row["METHOD"])
            try:
                smap = np.load(smap_pattern.format(**d),
                               allow_pickle=True)["saliency_map"]
                img = center_crop(
                    imageio.imread(orig_pattern.format(**d)),
                    convert_uint8=False)
                gt_mask = np.asarray(
                    imageio.imread(mask_pattern.format(**d))).astype(bool)
            except (IOError, OSError):
                if not params.get("ignore_missing_saliency_maps"):
                    raise
                continue
            smap_sorted = np.sort(smap, axis=None)[::-1]
            thr = smap_sorted[min(n_pixels, smap.size - 1)]
            pred_mask = smap > thr
            rgb = overlap_mask(smap, np.asarray(img, np.float64), gt_mask,
                               pred_mask)
            fpath = os.path.join(
                output_dir, str(keys[0]), "mask-%d" % row["MASK_ID"],
                row["METHOD"],
                "%s-%d-idflip.png" % (
                    str(row["ORIGINAL_BASENAME"]).replace("/", "-"),
                    row["ORIG_MASK_ID"]))
            Path(os.path.dirname(fpath)).mkdir(exist_ok=True, parents=True)
            imageio.imwrite(fpath,
                            (np.clip(rgb, 0, 1) * 255).astype(np.uint8))
            written.append(fpath)
    return written


def _threshold_schedule(threshold_type):
    """Threshold/percentile schedules (plot_inpainting_game.py:118-138)."""
    if threshold_type == "mass-threshold":
        return np.append(np.arange(2e-3, 0, -5e-6), 0), None
    if threshold_type in ("percent", "percent-pixels"):
        return None, np.unique(np.sort(np.append(
            100 * np.exp(-np.arange(0, 15, 0.1)), [0, 100])))
    if threshold_type == "percent-density":  # standard
        return None, np.unique(np.sort(np.append(np.arange(0, 100, 1),
                                                 [0, 100])))
    raise RuntimeError("Unknown threshold type %s (try mass-threshold or "
                       "percent)" % threshold_type)


def _mesh_of(net_dict):
    """The device mesh of the first meshed net of ``net_dict``, or None."""
    return next((n.mesh for n in net_dict.values()
                 if getattr(n, "mesh", None) is not None), None)


def _save_smap(path, smap):
    """A backup method's map, written whole or not at all (a rank of a
    mesh may read it while the first rank writes it)."""
    tmp = "%s.%d.tmp.npz" % (path, os.getpid())
    np.savez_compressed(tmp, saliency_map=smap)
    os.replace(tmp, path)


def run_inpaintinggame_analysis(hgame_thresholds, hgame_percentile, params,
                                net_dict):
    """Per-probe cached twin-cls + IoU passes -> nonmate_classification
    DataFrame (plot_inpainting_game.py:768-1295)."""
    import imageio.v2 as imageio
    import pandas as pd

    from xfr_torch.models import create_wbnet
    from xfr_torch.parallel.mesh import all_true

    write = writes(_mesh_of(net_dict))

    output_dir = params["output_dir"]
    cache_dir = params["cache_dir"]
    Path(cache_dir).mkdir(exist_ok=True, parents=True)
    params["SUFFIX_AGGR"] = [""]
    reprocess = params["reprocess"]
    seed = params["seed"]
    if params.get("output_subdir"):
        output_dir = os.path.join(output_dir, params["output_subdir"])
    Path(output_dir).mkdir(exist_ok=True, parents=True)

    data_dir = params.get("data_dir") or xfr_torch.inpaintgame2_dir
    smap_root = "%s{SUFFIX_AGGR}/" % params["smap_root"]
    smap_pattern = os.path.join(
        smap_root, "{NET}/subject_ID_{SUBJECT_ID}/{ORIGINAL_BASENAME}/"
        "inpainted/{MASK_ID:05d}-{METHOD}-saliency.npz")
    orig_pattern = os.path.join(
        data_dir, "aligned/{SUBJECT_ID}/{ORIGINAL_BASENAME}/"
        "inpainted/{MASK_ID:05d}_truth.png")
    mask_pattern = os.path.join(
        data_dir,
        "aligned/{SUBJECT_ID}/{ORIGINAL_BASENAME}/masks/{MASK_ID:05d}.png")

    inpainting_v2_data = {
        net: pd.read_csv(os.path.join(
            data_dir,
            "filtered_masks_threshold-{NET}.csv".format(NET=net)))
        for net in params["NET"]}
    for net in inpainting_v2_data:
        inpainting_v2_data[net]["OriginalFile"] = [
            orig_pattern.format(**row)
            for _, row in inpainting_v2_data[net].iterrows()]
        inpainting_v2_data[net]["NET"] = net

    subj_csv_pattern = os.path.join(data_dir, "subj-{SUBJECT_ID}.csv")
    if params["SUBJECT_ID"] is None:
        subj_files = glob.glob(os.path.join(data_dir, "subj-*.csv"))
        all_subj_data = pd.concat([pd.read_csv(f) for f in subj_files])
        params["SUBJECT_ID"] = \
            all_subj_data["SUBJECT_ID"].unique().tolist()
    else:
        all_subj_data = pd.concat([
            pd.read_csv(subj_csv_pattern.format(SUBJECT_ID=sid))
            for sid in params["SUBJECT_ID"]])
    all_subj_data["ORIGINAL_BASENAME"] = [
        os.path.splitext(fn)[0]
        for fn in all_subj_data["ORIGINAL_FILE"].values]

    def get_base_net(net):
        return net.split("+")[0]

    combined = pd.concat(inpainting_v2_data.values(), ignore_index=True)
    inpainting_v2_data = combined

    snet = None
    nonmate_cache_fns = set()
    classified_as_nonmate = []
    # One PROBE GROUP (all of a probe's method units, batched into one
    # multi-map device program via TwinClsBatch) stays in flight across
    # loop iterations: group k+1's twin-cls programs are enqueued (and
    # its host IoU passes computed) BEFORE group k's encode is drained,
    # so the device queue never idles on the per-unit host round trip.
    # Results are appended at drain time, preserving unit order.
    pending_units = [[]]

    def drain_pending():
        group, pending_units[0] = pending_units[0], []
        for ctx in group:
            try:
                cls_twin, pg_dist, pr_dist = ctx["finish"]()
            except IOError as e:
                if not ctx["ignore_missing"]:
                    raise e
                continue
            # CLS_AS_NONMATE / Orig_Cls_Nonmate / Twin_Cls_Nonmate are
            # NaN by design: the reference fills the same three columns
            # with np.nan (plot_inpainting_game.py:1170-1172); all
            # downstream stats read CLS_AS_TWIN.
            classified_as_nonmate.append(ctx["fields"] + (
                np.nan, np.nan, np.nan, cls_twin, cls_twin[0],
                cls_twin[-1],
                ctx["iou"], ctx["false_pos"], ctx["neg"], ctx["true_pos"],
                ctx["pos"]))
            if ctx["check_false_pos"] and ctx["false_pos"][-1] != ctx["neg"]:
                raise RuntimeError(
                    "False positive value for last threshold should be "
                    "the number of negative elements (%d), but is %d."
                    % (ctx["neg"], ctx["false_pos"][-1]))
    for net_name in params["NET"]:
        base_net = get_base_net(net_name)
        subjs_net_inp = inpainting_v2_data.loc[
            (inpainting_v2_data["NET"] == base_net) &
            (inpainting_v2_data["SUBJECT_ID"].isin(params["SUBJECT_ID"]))]
        if params.get("IMG_BASENAME"):
            subjs_net_inp = subjs_net_inp.loc[
                (subjs_net_inp["ORIGINAL_BASENAME"].isin(
                    params["IMG_BASENAME"])) |
                (subjs_net_inp["TRIPLET_SET"] == "REF")]

        for (subject_id, mask_id), ip2grp in subjs_net_inp.groupby(
                ["SUBJECT_ID", "MASK_ID"]):
            if mask_id not in params["MASK_ID"]:
                continue
            if snet is None or getattr(snet, "net_name", None) != net_name:
                if net_name in net_dict:
                    snet = net_dict[net_name]
                else:
                    snet = create_wbnet(net_name)
                    net_dict[net_name] = snet
                snet.net_name = net_name

            ip2ref = ip2grp.loc[ip2grp["TRIPLET_SET"] == "REF"]
            mate_embeds = snet.embeddings([
                os.path.join(data_dir, fn)
                for fn in ip2ref["OriginalFile"]])
            mate_embeds /= np.linalg.norm(mate_embeds, axis=1, keepdims=True)
            original_gal_embed = mate_embeds.mean(axis=0, keepdims=True)
            original_gal_embed /= np.linalg.norm(original_gal_embed, axis=1,
                                                 keepdims=True)

            nonmate_embeds = snet.embeddings([
                os.path.join(data_dir, fn)
                for fn in ip2ref["InpaintingFile"]])
            nonmate_embeds /= np.linalg.norm(nonmate_embeds, axis=1,
                                             keepdims=True)
            inpaint_gal_embed = nonmate_embeds.mean(axis=0, keepdims=True)
            inpaint_gal_embed /= np.linalg.norm(inpaint_gal_embed, axis=1,
                                                keepdims=True)

            ip2probe = ip2grp.loc[ip2grp["TRIPLET_SET"] == "PROBE"]
            original_imITF = snet.preprocess_loader([
                os.path.join(data_dir, fn)
                for fn in ip2probe["OriginalFile"]])
            inpaint_imITF = snet.preprocess_loader([
                os.path.join(data_dir, fn)
                for fn in ip2probe["InpaintingFile"]])

            for ((idx, row), (orig_im, orig_imT, orig_fn),
                 (inp_im, inp_imT, inp_fn)) in zip(
                    ip2probe.iterrows(), original_imITF, inpaint_imITF):
                orig_imT = orig_imT.cpu().numpy()
                inp_imT = inp_imT.cpu().numpy()

                # All of this probe's method maps share one image pair:
                # batch their blend+encode into ONE device program
                # (TwinClsBatch); cache hits never join the batch.
                twin_batch = inpaintgame.TwinClsBatch(
                    snet, orig_imT, inp_imT, original_gal_embed,
                    inpaint_gal_embed,
                    mask_threshold_method=params["threshold_type"],
                    thresholds=hgame_thresholds,
                    percentiles=hgame_percentile, seed=seed,
                    include_zero_elements=params["include_zero_saliency"],
                    mask_blur_sigma=params["mask_blur_sigma"])
                probe_group = []

                for method, suffix_aggr in itertools.product(
                        params["METHOD"], params["SUFFIX_AGGR"]):
                    if skip_combination(net=net_name, method=method,
                                        suffix_aggr=suffix_aggr):
                        continue

                    def launch_twin_cls():
                        d = row.to_dict()
                        d["METHOD"] = method
                        _crossnet_method_remap(d, method)
                        d["SUFFIX_AGGR"] = suffix_aggr
                        smap_filename = smap_pattern.format(**d)
                        try:
                            if method.split("+")[0] == "inpaintingMask":
                                raise IOError
                            smap = np.load(smap_filename)["saliency_map"]
                        except IOError as e:
                            inpainted_region = imageio.imread(
                                mask_pattern.format(**d))
                            smap = backupMethods(method, inpainted_region,
                                                 orig_imT, inp_imT, e)
                            if write:
                                _save_smap(smap_filename, smap)
                        smap = resize(smap, orig_imT.shape[1:], order=0)
                        smap = smap / smap.sum()
                        return twin_batch.launch(smap)

                    if params["threshold_type"] == "percent-density":
                        threshold_method_slug = "pct-density%d" % len(
                            hgame_percentile)
                    elif hgame_thresholds is not None:
                        threshold_method_slug = "Thresh%d" % len(
                            hgame_thresholds)
                    else:
                        threshold_method_slug = "Percentile%d" % len(
                            hgame_percentile)

                    cache_fn = (
                        "inpainted-id-hiding-game-twin-cls-dists"
                        "-{SUBJECT_ID}-{MASK_ID}-{ORIGINAL_BASENAME}-0"
                        "-{NET}-{METHOD}{SUFFIX_AGGR}{SEED}-RetProb_"
                        "MskBlur{MASK_BLUR_SIGMA}-"
                        "{THRESHOLDS}{ZERO_SALIENCY_SUFFIX}").format(
                        SUBJECT_ID=subject_id,
                        ORIGINAL_BASENAME=row["ORIGINAL_BASENAME"],
                        METHOD=method, NET=net_name,
                        SUFFIX_AGGR=suffix_aggr,
                        SEED="" if seed is None else "-Seed%d" % seed,
                        MASK_ID=mask_id, THRESHOLDS=threshold_method_slug,
                        ZERO_SALIENCY_SUFFIX="ExcludeZeroSaliency"
                        if not params["include_zero_saliency"] else "",
                        MASK_BLUR_SIGMA=params["mask_blur_sigma"])
                    assert cache_fn not in nonmate_cache_fns, (
                        "Are you displaying the same method multiple times?")
                    nonmate_cache_fns.add(cache_fn)

                    def calc_saliency_intersect_over_union():
                        d = row.to_dict()
                        d["METHOD"] = method
                        _crossnet_method_remap(d, method)
                        d["SUFFIX_AGGR"] = suffix_aggr
                        mask_filename = mask_pattern.format(**d)
                        inpainted_region = imageio.imread(mask_filename)
                        try:
                            if method == "diffOrigInpaint":
                                raise IOError
                            smap = np.load(smap_pattern.format(**d))[
                                "saliency_map"]
                        except IOError as e:
                            smap = backupMethods(method, inpainted_region,
                                                 orig_imT, inp_imT, e)
                        smap = smap / smap.sum()
                        neg = np.sum(inpainted_region == 0)
                        pos = np.sum(inpainted_region != 0)
                        iou, fp, tp = \
                            inpaintgame. \
                            intersect_over_union_thresholded_saliency(
                                smap, inpainted_region,
                                mask_threshold_method=params[
                                    "threshold_type"],
                                thresholds=hgame_thresholds,
                                percentiles=hgame_percentile, seed=seed,
                                include_zero_elements=params[
                                    "include_zero_saliency"],
                                return_fpos=True, return_tpos=True)
                        return iou, fp, neg, tp, pos

                    try:
                        # Launch the twin-cls device blend+encode first,
                        # compute the (host, numpy) IoU pass while it
                        # runs, then drain — the overlap hides the IoU
                        # wall-clock behind the device encode.
                        finish_twin_cls = cache_npz_launch(
                            cache_fn, launch_twin_cls,
                            reprocess_=reprocess, cache_dir=cache_dir,
                            save_dict_={
                                "hgame_thresholds": hgame_thresholds,
                                "hgame_percentile": hgame_percentile},
                            write_=write,
                            agree_=None if getattr(snet, "mesh", None) is None
                            else (lambda hit, m=snet.mesh: all_true(m, hit)))
                        iou_fn = (
                            "inpainted-id-hiding-game-saliency-IoU-withcomp"
                            "-py3-{SUBJECT_ID}-{MASK_ID}-"
                            "{ORIGINAL_BASENAME}-0-{NET}-{METHOD}"
                            "{SUFFIX_AGGR}_{THRESHOLDS}"
                            "{ZERO_SALIENCY_SUFFIX}").format(
                            SUBJECT_ID=subject_id,
                            ORIGINAL_BASENAME=row["ORIGINAL_BASENAME"],
                            METHOD=method, NET=net_name,
                            SUFFIX_AGGR=suffix_aggr, MASK_ID=mask_id,
                            THRESHOLDS=threshold_method_slug,
                            ZERO_SALIENCY_SUFFIX="ExcludeZeroSaliency"
                            if not params["include_zero_saliency"] else "")
                        saliency_gt_iou, false_pos, neg, true_pos, pos = \
                            cache_npz(
                                iou_fn, calc_saliency_intersect_over_union,
                                reprocess_=reprocess, cache_dir=cache_dir,
                                save_dict_={
                                    "hgame_thresholds": hgame_thresholds,
                                    "hgame_percentile": hgame_percentile},
                                write_=write)
                    except IOError as e:
                        if not params["ignore_missing_saliency_maps"]:
                            raise e
                        continue
                    probe_group.append({
                        "finish": finish_twin_cls,
                        "fields": (net_name, method,
                                   row["ORIGINAL_BASENAME"], inp_fn,
                                   suffix_aggr, subject_id, mask_id),
                        "iou": saliency_gt_iou, "false_pos": false_pos,
                        "neg": neg, "true_pos": true_pos, "pos": pos,
                        "check_false_pos": params["include_zero_saliency"],
                        "ignore_missing":
                            params["ignore_missing_saliency_maps"],
                    })

                # this probe's units are all launched (one multi-map
                # program); drain the previous group while it runs, then
                # leave this group pending
                twin_batch.flush()
                drain_pending()
                pending_units[0] = probe_group

    drain_pending()
    nonmate_classification = _to_dataframe(classified_as_nonmate)
    if write:
        with open(os.path.join(cache_dir, "nonmate-cls.pkl"), "wb") as f:
            pickle.dump(nonmate_classification, f)
    return nonmate_classification, inpainting_v2_data


def _to_dataframe(rows):
    import pandas as pd

    return pd.DataFrame(rows, columns=[
        "NET", "METHOD", "ORIGINAL_BASENAME", "InpaintingFile",
        "SUFFIX_AGGR", "SUBJECT_ID", "MASK_ID", "CLS_AS_NONMATE",
        "Orig_Cls_Nonmate", "Twin_Cls_Nonmate", "CLS_AS_TWIN",
        "Orig_Cls_Twin", "Twin_Cls_Twin", "SALIENCY_GT_IOU", "FALSE_POS",
        "NEG", "TRUE_POS", "POS"])


def generate_plots(nonmate_classification, hgame_thresholds,
                   hgame_percentile, params, human_net_labels):
    """Aggregate plots + results.csv (plot_inpainting_game.py:1299-1525)."""
    import matplotlib
    matplotlib.use("agg")
    import matplotlib.pyplot as plt

    output_dir = params["output_dir"]
    if params.get("output_subdir"):
        output_dir = os.path.join(output_dir, params["output_subdir"])
    Path(output_dir).mkdir(exist_ok=True, parents=True)
    balance_masks = params["balance_masks"]

    unequal_method_entries = False
    for net, grp0 in nonmate_classification.groupby("NET"):
        num_entries = None
        for method, grp1 in grp0.groupby("METHOD"):
            if num_entries is None:
                num_entries = len(grp1)
            elif num_entries != len(grp1):
                unequal_method_entries = True

    net_indices = OrderedDict(
        (net, ni) for ni, net in enumerate(params["NET"]))
    cNets = len(net_indices)
    plt_scale = 2

    figL, axesL = plt.subplots(1, 1, figsize=(5 * plt_scale, 2 * plt_scale),
                               sharex=True, sharey="row", squeeze=False)
    fig4, axes4 = plt.subplots(1, cNets,
                               figsize=(6 * cNets * plt_scale, 4 * plt_scale),
                               sharex=True, sharey="row", squeeze=False)
    fig4s, axes4s = plt.subplots(
        1, cNets, figsize=(6 * cNets * plt_scale, 4 * plt_scale),
        sharex=True, sharey="row", squeeze=False)

    figR, axesR = plt.subplots(1, cNets,
                               figsize=(6 * cNets * plt_scale,
                                        4 * plt_scale),
                               sharex=True, sharey="row", squeeze=False)

    cls_at_fpr_method = {}
    lines = []
    for (method, suffix_aggr, net), grp in nonmate_classification.groupby(
            ["METHOD", "SUFFIX_AGGR", "NET"], sort=False):
        hnet = human_net_labels[net]
        simplified_hnet = human_net_labels[net.split("+")[0]]
        label, method_idx, slabel = method_label_and_idx(
            method, params["METHOD"], human_net_labels)
        ni = net_indices[net]
        # saliency-threshold ROC (the reference defines this plot but
        # never wires it, plot_inpainting_game.py:529-566; here it ships)
        plot_roc_curve(axesR[0, ni], grp, hnet, label,
                       method_idx=method_idx, balance_masks=balance_masks,
                       leftmost=(ni == 0))
        plot_cls_vs_fpr(axes4[0, ni], grp, hnet, label,
                        method_idx=method_idx, balance_masks=balance_masks,
                        leftmost=(ni == 0))
        plot_cls_vs_fpr(axes4s[0, ni], grp, simplified_hnet, slabel,
                        method_idx=method_idx, balance_masks=balance_masks,
                        leftmost=(ni == 0))
        if ni == 0:
            line, cls_at_fpr = plot_cls_vs_fpr(
                axesL[0, ni], grp, hnet, slabel, method_idx=method_idx,
                balance_masks=balance_masks, leftmost=(ni == 0))
            cls_at_fpr_method[method] = cls_at_fpr
            line.set_linewidth(4)
            lines.append(line)
            axesL[0, ni].legend(loc="center")
            axesL[0, ni].axis("off")

    bal = "balanced-by-mask" if balance_masks else "unbalanced"
    figR.subplots_adjust(top=0.95, bottom=0.1, left=0.15, right=0.96,
                         hspace=0.9, wspace=0.05)
    show.savefig("inpainted_twin_game_roc_%s.png" % bal, figR,
                 output_dir=output_dir)
    fig4s.subplots_adjust(top=0.95, bottom=0.1, left=0.15, right=0.96,
                          hspace=0.9, wspace=0.05)
    show.savefig("inpainted_twin_game_%s-net-split_simplified.png" % bal,
                 fig4s, output_dir=output_dir)
    fig4.subplots_adjust(top=0.95, bottom=0.1, left=0.15, right=0.96,
                         hspace=0.9, wspace=0.05)
    show.savefig("inpainted_twin_game_%s-net-split.png" % bal, fig4,
                 output_dir=output_dir)

    for line in lines:
        line.set_visible(False)
    axesL[0, 0].set_title("")
    show.savefig("inpainted_twin_game_legend.png", figL,
                 output_dir=output_dir, transparent=True)
    for ax in list(axes4s.flat) + list(axes4.flat):
        legend = ax.get_legend()
        if legend is not None:
            legend.remove()
    show.savefig("inpainted_twin_game_%s-net-split_simplified-nolegend.png"
                 % bal, fig4s, output_dir=output_dir)
    show.savefig("inpainted_twin_game_%s-net-split-nolegend.png" % bal,
                 fig4, output_dir=output_dir)
    plt.close("all")

    cls_at_fpr_method_msk = defaultdict(dict)
    for mask_id, grp0 in nonmate_classification.groupby("MASK_ID",
                                                        sort=False):
        fig4s, axes4s = plt.subplots(
            1, 1, figsize=(8 * cNets * plt_scale, 1.8 * plt_scale),
            sharex=True, sharey="row", squeeze=False)
        for (method, suffix_aggr), grp in grp0.groupby(
                ["METHOD", "SUFFIX_AGGR"], sort=False):
            label, method_idx, slabel = method_label_and_idx(
                method, params["METHOD"], human_net_labels)
            _, cls_at_fpr = plot_cls_vs_fpr(
                axes4s[0, 0], grp, None, slabel, method_idx=method_idx,
                balance_masks=balance_masks, leftmost=True)
            cls_at_fpr_method_msk[method][mask_id] = cls_at_fpr
            axes4s[0, 0].set(ylabel="Classified as\nInpainted\nNon-mate")
            axes4s[0, 0].xaxis.set_major_formatter(
                plt.FuncFormatter(tickformatter))
            legend = axes4s[0, 0].get_legend()
            if legend is not None:
                legend.remove()
        fig4s.subplots_adjust(top=0.98, bottom=0.22, left=0.16, right=0.96,
                              hspace=0.9, wspace=0.05)
        try:
            region = list(regions.keys())[mask_id]
        except IndexError as e:
            if mask_id == 167:
                region = "left-or-right-face"
            elif mask_id == 189:
                region = "left-or-right-eye"
            else:
                raise e
        show.savefig("inpainted_twin_game_simplified_%s_mask%d_%s.png"
                     % (bal, mask_id, region), fig4s, output_dir=output_dir)
        plt.close("all")

    import pandas as pd

    csv_rows = []
    for method, cls_at_fpr_maskid in cls_at_fpr_method_msk.items():
        nrow = {"method": method,
                "all,far=1e-2": cls_at_fpr_method[method][1e-2],
                "all,far=5e-2": cls_at_fpr_method[method][5e-2]}
        for mask_id in [2, 189, 5]:
            if mask_id not in cls_at_fpr_maskid:
                continue
            cls_at_fpr = cls_at_fpr_maskid[mask_id]
            nrow["%s,far=1e-2" % regions_human_labels[mask_id]] = \
                cls_at_fpr[1e-2]
            nrow["%s,far=5e-2" % regions_human_labels[mask_id]] = \
                cls_at_fpr[5e-2]
        csv_rows.append(nrow)
    pd.DataFrame(csv_rows).to_csv(os.path.join(output_dir, "results.csv"))

    if unequal_method_entries:
        print("WARNING!!! Unequal method entries! Don't trust result!!!!")
    return cls_at_fpr_method, cls_at_fpr_method_msk


def make_inpaintinggame_plots(net_dict, params, human_net_labels=None):
    """Analysis + plots entry point (plot_inpainting_game.py:113-237)."""
    if human_net_labels is None:
        human_net_labels = human_net_labels_
    hgame_thresholds, hgame_percentile = _threshold_schedule(
        params["threshold_type"])

    nonmate_classification, inpainting_v2_data = run_inpaintinggame_analysis(
        hgame_thresholds, hgame_percentile, params=params, net_dict=net_dict)

    nonmate_classification["ORIG_MASK_ID"] = \
        nonmate_classification["MASK_ID"]
    # merge asymmetric L/R masks: (6,7)->167, (8,9)->189
    for base_net, _ in inpainting_v2_data.groupby("NET"):
        for left, right in [(6, 7), (8, 9)]:
            sel = ((nonmate_classification["NET"] == base_net) &
                   ((nonmate_classification["MASK_ID"] == left) |
                    (nonmate_classification["MASK_ID"] == right)))
            nonmate_classification.loc[sel, "MASK_ID"] = \
                100 + 10 * left + right
    if not writes(_mesh_of(net_dict)):
        return nonmate_classification  # a mesh's first rank writes

    generate_plots(nonmate_classification, hgame_thresholds,
                   hgame_percentile, params, human_net_labels)

    # dataset stats report + figure, then the per-probe identity-flip
    # overlay export (reference tail order, plot_inpainting_game.py:
    # 171-287)
    output_dir = params["output_dir"]
    if params.get("output_subdir"):
        output_dir = os.path.join(output_dir, params["output_subdir"])
    dataset_stats(nonmate_classification, inpainting_v2_data, output_dir)
    export_mask_overlaps(nonmate_classification, params)
    return nonmate_classification
