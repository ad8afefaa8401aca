"""The inpainting game's evaluation, one probe group a unit, as
``run_inpaintinggame_analysis`` runs it: a probe/twin pair, its two
gallery centroids, and the group's saliency maps batched into one
``TwinClsBatch`` program, each map's IoU curve computed on the host while
the card encodes, one group in flight ahead.

Traffic keys: ``maps`` (saliency maps a group), ``percentiles`` (the
percent-density thresholds, [first, last] inclusive), ``threshold_seed``,
``include_zero_elements``, ``box`` (the salient and inpainted region as
[top, bottom, left, right] shares of the image), ``salient_boost``,
``orig_scale`` and ``twin_scale`` (the probe is U(0, orig_scale), the
twin the probe plus U(0, twin_scale)), ``gallery_copies`` (noisy copies
of each side, U(0, gallery_noise) added), ``pool_values`` (the pool of
distinct pairs holds about this many pixel values, so a smaller image
gets more pairs), ``check_units``, ``trace_units``.

Images are in the network's input format ([C,H,W] float32), drawn on the
device from the run's seed; each group's maps are drawn on the host from
the seed and the group's index.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from xfr_bench import harness as H

FAMILY = "eval"
RATE = "evals_per_s"
RANGES = ("eval.launch", "eval.iou", "eval.drain")


# the control: the reference in the precision below float32 with TF32
# allowed (bfloat16)
CONTROL = {"dtype": torch.bfloat16}


def per_unit(tr):
    """Evaluations (maps) a unit."""
    return tr["maps"]


def pool_size(cfg, tr):
    return max(1, tr["pool_values"] // math.prod(cfg["input_chw"]))


def pairs(cfg, tr, seed, device):
    """(origs, twins, gallery images [P, 2*copies, C, H, W]) of the pool,
    on the device."""
    P, chw = pool_size(cfg, tr), tuple(cfg["input_chw"])
    g = H.generator(seed, device, "pairs")
    origs = torch.rand((P,) + chw, generator=g, device=device) \
        * tr["orig_scale"]
    twins = origs + torch.rand((P,) + chw, generator=g, device=device) \
        * tr["twin_scale"]
    k = tr["gallery_copies"]
    g = H.generator(seed, device, "gallery")
    noise = torch.rand((P, 2 * k) + chw, generator=g, device=device) \
        * tr["gallery_noise"]
    gal = torch.cat([origs[:, None], twins[:, None]], 1).repeat_interleave(
        k, dim=1) + noise
    return origs, twins, gal


def group_maps(cfg, tr, seed, key):
    """The saliency maps of the group drawn under ``key`` (float64, unit
    mass, boosted in the box) and the box as a boolean region."""
    _, Hh, W = cfg["input_chw"]
    t, b, l, r = tr["box"]
    box = (slice(int(t * Hh), int(b * Hh)), slice(int(l * W), int(r * W)))
    rng = np.random.RandomState(H.derive(seed, "maps", key))
    maps = []
    for _ in range(tr["maps"]):
        m = rng.rand(Hh, W)
        m[box] += tr["salient_boost"]
        maps.append(m / m.sum())
    gt = np.zeros((Hh, W), bool)
    gt[box] = True
    return maps, gt


def percentiles(tr):
    lo, hi = tr["percentiles"]
    return np.arange(lo, hi + 1)


class Cell:
    """The program's side of one run: set-up in the constructor, then
    ``launch``/``drain`` per unit, then ``release``."""

    def __init__(self, cfg, tr, seed, device, ranges):
        from xfr_torch.inpainting_game import protocol

        self.protocol = protocol
        self.cfg, self.tr, self.seed, self.ranges = cfg, tr, seed, ranges
        params = H.weights(cfg, seed, device)
        self.wb = cfg["program"].program(cfg, params, device)
        origs, twins, gal = pairs(cfg, tr, seed, device)
        k = tr["gallery_copies"]
        cents = []
        for i in range(0, gal.shape[0], 64):
            block = gal[i:i + 64]
            e = self.wb.embeddings(block.reshape((-1,) + block.shape[2:]))
            e = e.reshape(block.shape[0], 2, k, -1)
            c = e.mean(2)
            cents.append(c / np.linalg.norm(c, axis=-1, keepdims=True))
        self.cents = np.concatenate(cents)  # [P, 2, D]
        self.origs = origs.cpu().numpy()
        self.twins = twins.cpu().numpy()
        del origs, twins, gal
        self.kw = dict(mask_threshold_method="percent-density",
                       percentiles=percentiles(tr),
                       seed=tr["threshold_seed"],
                       include_zero_elements=tr["include_zero_elements"])
        self.iou_s = 0.0
        self.out = {}
        # warm-up: two groups of other maps, pipelined as in the window
        P = len(self.origs)
        warm = [self._launch(P - 1 - i, f"warm{i}") for i in (0, 1)]
        for w in warm:
            self._drain(w)
        self.iou_s = 0.0

    def _launch(self, p, key):
        p %= len(self.origs)
        with self.ranges("eval.launch"):
            maps, gt = group_maps(self.cfg, self.tr, self.seed, key)
            og, ig = self.cents[p, 0:1], self.cents[p, 1:2]
            batch = self.protocol.TwinClsBatch(
                self.wb, self.origs[p], self.twins[p], og, ig, **self.kw)
        fins, ious = [], []
        for smap in maps:
            with self.ranges("eval.launch"):
                fins.append(batch.launch(smap))
            with self.ranges("eval.iou"):
                t0 = time.perf_counter()
                ious.append(
                    self.protocol.intersect_over_union_thresholded_saliency(
                        smap, gt, **self.kw))
                self.iou_s += time.perf_counter() - t0
        with self.ranges("eval.launch"):
            batch.flush()
        return fins, ious

    def _drain(self, launched):
        fins, ious = launched
        with self.ranges("eval.drain"):
            res = [f() for f in fins]
        return {"cls": np.stack([r[0] for r in res]),
                "pg": np.stack([r[1] for r in res]).astype(np.float64),
                "pr": np.stack([r[2] for r in res]).astype(np.float64),
                "iou": np.stack(ious)}

    def launch(self, u):
        return self._launch(u, u)

    def drain(self, launched, u):
        self.out[u] = self._drain(launched)

    def release(self):
        self.wb = None

    def stage_seconds_at_peak(self):
        """Seconds one group's needed FLOPs take at the H100's peak: the
        maps' threshold blends, one encode a threshold, TF32 allowed."""
        cfg = self.cfg
        enc = 2 * cfg["reference"].forward_macs(cfg, tuple(cfg["input_chw"]))
        rows = self.tr["maps"] * len(percentiles(self.tr))
        return [rows * enc / H.PEAK_FLOPS["tf32"]]

    def counters(self):
        return {"host_iou_s": self.iou_s}


def reference_outputs(cfg, tr, seed, device, units, dtype=torch.float32):
    """The reference's {unit: {"cls", "pg", "pr", "iou"}} for ``units``,
    every step from the seed's images; with ``dtype`` bfloat16 it encodes
    in bfloat16 (the control, put in the program's place)."""
    from xfr_bench.reference import evaluation as RE
    from xfr_bench.reference.strise import precision

    R = cfg["reference"]
    params = H.weights(cfg, seed, device)
    params = {n: {k: v.to(dtype) for k, v in p.items()}
              for n, p in params.items()}
    origs, twins, gal = pairs(cfg, tr, seed, device)
    P = origs.shape[0]
    k = tr["gallery_copies"]

    def embed(x):
        return R.encode(params, cfg, x.to(dtype)).float()

    out = {}
    with precision(False), torch.no_grad():
        for u in units:
            p = u % P
            maps, gt = group_maps(cfg, tr, seed, u)
            go = RE.centroid(embed, gal[p, :k])
            gi = RE.centroid(embed, gal[p, k:])
            res = {"cls": [], "pg": [], "pr": [], "iou": []}
            for smap in maps:
                masks = RE.threshold_masks(
                    smap, percentiles(tr), tr["threshold_seed"],
                    include_zero=tr["include_zero_elements"])
                _, pg, pr = RE.evaluate_map(embed, origs[p], twins[p], go, gi,
                                            masks)
                pg, pr = pg.double().cpu().numpy(), pr.double().cpu().numpy()
                res["cls"].append(pg < pr)
                res["pg"].append(pg)
                res["pr"].append(pr)
                res["iou"].append(RE.iou(masks, gt))
            out[u] = {key: np.stack(v) for key, v in res.items()}
    return out


def compare(got, want):
    """The worst over the units of ``want`` of: the distances' largest gap
    as a share of the reference's largest distance in that map; the
    reference's twin-classification margin (|pg - pr| as such a share) at
    the largest classification that differs; and the IoU curves' largest
    gap."""
    worst = {"dist_gap": 0.0, "cls_margin": 0.0, "iou_gap": 0.0}
    for u, ref in want.items():
        g = got[u]
        scale = np.maximum(ref["pg"], ref["pr"]).max(axis=1, keepdims=True)
        gap = np.maximum(np.abs(g["pg"] - ref["pg"]),
                         np.abs(g["pr"] - ref["pr"])) / scale
        worst["dist_gap"] = max(worst["dist_gap"], float(gap.max()))
        margin = np.abs(ref["pg"] - ref["pr"]) / scale
        flip = g["cls"] != ref["cls"]
        if flip.any():
            worst["cls_margin"] = max(worst["cls_margin"],
                                      float(margin[flip].max()))
        worst["iou_gap"] = max(worst["iou_gap"], float(
            np.abs(g["iou"] - ref["iou"]).max()))
    return worst
