"""Inpainting-game core protocol (port of xfr_tpu/inpainting_game/protocol.py;
reference: python/xfr/inpainting_game/inpainting_game.py).

Given a saliency map, build a family of binary masks at increasing
saliency-mass thresholds ('percent-density'), blend the original probe
toward its inpainted twin under each mask, embed all blends in one batched
device call, and record at which threshold the matcher flips identity.
"""

from __future__ import annotations

import numpy as np

from xfr_torch.utils.profiling import span


def _threshold_plane(saliency_map, threshold_method, percentiles=None,
                     thresholds=None, seed=None, max_noise=1e-9,
                     include_zero_elements=True):
    """The scalar plane + thresholds whose ``plane > thr[t]`` comparisons
    define the threshold-mask family (shared by mask materialization and
    the count-based fast paths; tie-breaking noise is seeded numpy,
    matching the reference exactly — inpainting_game.py:12-64)."""
    np.random.seed(seed)
    if include_zero_elements:
        nonzero_saliency = 1
    else:
        nonzero_saliency = saliency_map != 0

    noisy = (saliency_map +
             nonzero_saliency * np.random.rand(*saliency_map.shape)
             * max_noise)
    noisy = noisy / noisy.sum()

    if threshold_method == "percent-density":
        order = np.argsort(noisy.flat)
        norm_cdf = np.cumsum(noisy.flat[order])
        noisy.flat[order] = norm_cdf
        noisy = noisy / noisy.max()  # float-error correction
        thresholds = 1.0 - percentiles.astype(noisy.dtype) / 100
        if percentiles[-1] == 100:
            thresholds[-1] = 0
    elif thresholds is None:
        thresholds = np.percentile(noisy, 100 - percentiles)
        if percentiles[0] == 0:
            thresholds[0] = 1
        if percentiles[-1] == 100:
            thresholds[-1] = 0
    return noisy, np.asarray(thresholds)


def create_threshold_masks(saliency_map, threshold_method, percentiles=None,
                           thresholds=None, seed=None, max_noise=1e-9,
                           include_zero_elements=True, blur_sigma=None):
    """Saliency map -> [T,H,W] boolean (or blurred float) masks
    (reference: inpainting_game.py:12-77).

    percent-density: mask t covers the top percentiles[t]% of total saliency
    *mass* (CDF), the protocol standard (run_inpainting_game_eval.py:124).
    Tie-breaking noise is seeded numpy, matching the reference exactly.
    """
    noisy, thresholds = _threshold_plane(
        saliency_map, threshold_method, percentiles=percentiles,
        thresholds=thresholds, seed=seed, max_noise=max_noise,
        include_zero_elements=include_zero_elements)

    # everything greater than threshold is inpainted
    masks = noisy[np.newaxis, ...] > thresholds[:, np.newaxis, np.newaxis]

    if blur_sigma is not None and blur_sigma > 0:
        from xfr_torch.utils.image import gaussian

        masks = masks.astype(saliency_map.dtype)
        for i in range(masks.shape[0]):
            if percentiles[i] == 100:
                continue
            masks[i] = gaussian(
                masks[i], blur_sigma * np.min(saliency_map.shape) / 100.0)
    return masks


def launch_classified_as_inpainted_twin(snet, original_imT, inpaint_imT,
                                        original_gal_embed,
                                        inpaint_gal_embed,
                                        saliency_map, mask_threshold_method,
                                        include_zero_elements=True,
                                        mask_blur_sigma=None,
                                        percentiles=None, thresholds=None,
                                        seed=None,
                                        binary_classification=True):
    """Launch/finish form of :func:`classified_as_inpainted_twin`: when the
    device blend path is available the embed programs are enqueued and a
    zero-argument ``finish()`` is returned, so the caller can overlap host
    work (the IoU curve, the next unit's mask build) with the device
    encode; otherwise the result is computed eagerly and ``finish()`` just
    returns it."""
    binary = not (mask_blur_sigma is not None and mask_blur_sigma > 0)
    device_ok = (binary and original_imT.ndim == 3
                 and original_imT.shape[0] in (1, 3)
                 and hasattr(snet, "launch_blend_embeddings"))

    plane = thr = counts = None
    if device_ok:
        with span("xfr.eval.plane"):
            plane, thr = _threshold_plane(
                saliency_map, mask_threshold_method, percentiles=percentiles,
                thresholds=thresholds, seed=seed,
                include_zero_elements=include_zero_elements)
            if (hasattr(snet, "launch_blend_embeddings_counts")
                    and len(thr) <= 255 and bool(np.all(np.diff(thr) <= 0))):
                counts = np.searchsorted(np.sort(thr), plane.ravel(),
                                         side="left").astype(np.uint8)
    counts_ok = counts is not None
    if not counts_ok:
        masks = (plane[np.newaxis] > thr[:, np.newaxis, np.newaxis]) \
            if plane is not None else create_threshold_masks(
                saliency_map, threshold_method=mask_threshold_method,
                percentiles=percentiles, thresholds=thresholds, seed=seed,
                include_zero_elements=include_zero_elements,
                blur_sigma=mask_blur_sigma)

    if device_ok:
        # Device fast path: compact mask upload + on-device blend+encode
        # (see Whitebox.launch_blend_embeddings).  Binary masks make the
        # blend a per-pixel select, so embeddings are bit-identical to
        # the host float64 blend path.  Descending thresholds mean the
        # family is monotone by construction, so the enter-count plane
        # (#(thr_t < plane[p]), one searchsorted) replaces the [T,H,W]
        # materialization entirely — same integers as masks.sum(0).
        if counts_ok:
            finish_embeds = snet.launch_blend_embeddings_counts(
                original_imT, inpaint_imT, counts, len(thr), norm=True)
        else:
            finish_embeds = snet.launch_blend_embeddings(
                original_imT, inpaint_imT, masks, norm=True)

        def finish():
            blend_embeds = finish_embeds()
            # same double-normalization sequence as the host path (the
            # second divide is a float32 near-no-op but keeps paths
            # identical)
            blend_embeds = blend_embeds / np.linalg.norm(
                blend_embeds, axis=1, keepdims=True)
            pr_dist = np.linalg.norm(blend_embeds - original_gal_embed,
                                     axis=1)
            pg_dist = np.linalg.norm(blend_embeds - inpaint_gal_embed,
                                     axis=1)
            classified_as_twin = pg_dist < pr_dist
            assert not classified_as_twin[0], (
                "mask-0 blend (pure original) already classifies as the "
                "twin")
            return classified_as_twin, pg_dist, pr_dist

        return finish

    result = _host_classified_as_inpainted_twin(
        snet, original_imT, inpaint_imT, original_gal_embed,
        inpaint_gal_embed, masks)
    return lambda: result


class TwinClsBatch:
    """Batch the twin-classification device programs of several saliency
    maps that share ONE probe/twin image pair into a single scanned
    blend+encode program.

    The analysis stage evaluates every saliency method of a probe against
    the same image pair (reference: plot_inpainting_game.py:1125-1161
    loops methods inside the probe loop); a lone ~100-row blend+encode
    program is dominated by per-program dispatch on the device link, so
    batching a probe's M method maps into one M*T-row scan amortizes that
    cost M-fold.  Each map's per-step [bs,...] encode batches are
    identical to the single-map program's.

    Usage: call :meth:`launch` per saliency map (returns the same
    ``finish() -> (cls_twin, pg_dist, pr_dist)`` contract as
    :func:`launch_classified_as_inpainted_twin`), then :meth:`flush` once
    all of the probe's maps are launched; drain finishes afterwards.
    Maps that don't qualify for the batched counts path (soft masks,
    non-monotone families) fall back to the single-map launch
    transparently.  Under a meshed net the multi-map program splits its
    flat step list over 'dp' (``Whitebox._launch_counts_steps``), so
    ``--mesh auto`` keeps the same program and the same results.
    """

    def __init__(self, snet, original_imT, inpaint_imT, original_gal_embed,
                 inpaint_gal_embed, mask_threshold_method,
                 include_zero_elements=True, mask_blur_sigma=None,
                 percentiles=None, thresholds=None, seed=None):
        self.snet = snet
        self.original_imT = original_imT
        self.inpaint_imT = inpaint_imT
        self.original_gal_embed = original_gal_embed
        self.inpaint_gal_embed = inpaint_gal_embed
        self.mask_threshold_method = mask_threshold_method
        self.include_zero_elements = include_zero_elements
        self.mask_blur_sigma = mask_blur_sigma
        self.percentiles = percentiles
        self.thresholds = thresholds
        self.seed = seed
        self._counts = []
        self._T = None
        self._finish_embeds = None
        self._result = None

    def _single(self, saliency_map):
        return launch_classified_as_inpainted_twin(
            self.snet, self.original_imT, self.inpaint_imT,
            self.original_gal_embed, self.inpaint_gal_embed, saliency_map,
            self.mask_threshold_method,
            include_zero_elements=self.include_zero_elements,
            mask_blur_sigma=self.mask_blur_sigma,
            percentiles=self.percentiles, thresholds=self.thresholds,
            seed=self.seed)

    def launch(self, saliency_map):
        binary = not (self.mask_blur_sigma is not None
                      and self.mask_blur_sigma > 0)
        snet = self.snet
        device_ok = (binary and self.original_imT.ndim == 3
                     and self.original_imT.shape[0] in (1, 3)
                     and hasattr(snet,
                                 "launch_blend_embeddings_counts_multi")
                     and self._finish_embeds is None)  # not yet flushed
        if not device_ok:
            return self._single(saliency_map)
        with span("xfr.eval.plane"):
            plane, thr = _threshold_plane(
                saliency_map, self.mask_threshold_method,
                percentiles=self.percentiles, thresholds=self.thresholds,
                seed=self.seed,
                include_zero_elements=self.include_zero_elements)
            mono = len(thr) <= 255 and bool(np.all(np.diff(thr) <= 0))
            if mono:
                counts = np.searchsorted(np.sort(thr), plane.ravel(),
                                         side="left").astype(np.uint8)
        if not mono:
            return self._single(saliency_map)
        if self._T is None:
            self._T = len(thr)
        assert len(thr) == self._T, (
            "all maps of a TwinClsBatch must share one threshold schedule")
        idx = len(self._counts)
        self._counts.append(counts)

        def finish():
            blend_embeds = self._embeds()[idx]
            blend_embeds = blend_embeds / np.linalg.norm(
                blend_embeds, axis=1, keepdims=True)
            pr_dist = np.linalg.norm(blend_embeds - self.original_gal_embed,
                                     axis=1)
            pg_dist = np.linalg.norm(blend_embeds - self.inpaint_gal_embed,
                                     axis=1)
            classified_as_twin = pg_dist < pr_dist
            assert not classified_as_twin[0], (
                "mask-0 blend (pure original) already classifies as the "
                "twin")
            return classified_as_twin, pg_dist, pr_dist

        return finish

    def flush(self):
        """Enqueue the one multi-map device program (no-op if empty or
        already flushed).  A single-map batch reuses the single-map
        program — same math, and it is the one already compiled by
        non-batched callers (a resumed run with one cache miss per probe
        shouldn't pay a fresh remote compile)."""
        if not self._counts or self._finish_embeds is not None:
            return
        if len(self._counts) == 1:
            inner = self.snet.launch_blend_embeddings_counts(
                self.original_imT, self.inpaint_imT, self._counts[0],
                self._T, norm=True)
            self._finish_embeds = lambda: inner()[None]
        else:
            self._finish_embeds = \
                self.snet.launch_blend_embeddings_counts_multi(
                    self.original_imT, self.inpaint_imT,
                    np.stack(self._counts), self._T, norm=True)

    def _embeds(self):
        self.flush()
        if self._result is None:
            self._result = self._finish_embeds()
        return self._result


def classified_as_inpainted_twin(snet, original_imT, inpaint_imT,
                                 original_gal_embed, inpaint_gal_embed,
                                 saliency_map, mask_threshold_method,
                                 include_zero_elements=True,
                                 mask_blur_sigma=None, percentiles=None,
                                 thresholds=None, seed=None,
                                 binary_classification=True,
                                 return_transitions=False):
    """Blend probe -> twin under threshold masks, embed, and classify each
    blend by nearest gallery centroid (reference: inpainting_game.py:80-146).

    All blends embed in one batched call through snet.embeddings — the
    reference's per-probe hot loop (inpainting_game.py:127-134).
    """
    if not return_transitions:
        return launch_classified_as_inpainted_twin(
            snet, original_imT, inpaint_imT, original_gal_embed,
            inpaint_gal_embed, saliency_map, mask_threshold_method,
            include_zero_elements=include_zero_elements,
            mask_blur_sigma=mask_blur_sigma, percentiles=percentiles,
            thresholds=thresholds, seed=seed,
            binary_classification=binary_classification)()

    masks = create_threshold_masks(
        saliency_map, threshold_method=mask_threshold_method,
        percentiles=percentiles, thresholds=thresholds, seed=seed,
        include_zero_elements=include_zero_elements,
        blur_sigma=mask_blur_sigma)
    return _host_classified_as_inpainted_twin(
        snet, original_imT, inpaint_imT, original_gal_embed,
        inpaint_gal_embed, masks, return_transitions=True)


def _host_classified_as_inpainted_twin(snet, original_imT, inpaint_imT,
                                       original_gal_embed,
                                       inpaint_gal_embed, masks,
                                       return_transitions=False):
    """Host blend path: float64 numpy blends + one batched embeddings call
    (used for soft/blurred masks and nets without the device blend API)."""
    if original_imT.shape[0] == 1 or original_imT.shape[-1] != 3:
        rgb_masks = masks[:, np.newaxis, ...]  # CHW (1 or C broadcast)
    elif original_imT.shape[0] == 3 or original_imT.shape[-1] != 3:
        rgb_masks = np.repeat(masks[:, np.newaxis, :, :], 3, axis=1)
    else:
        rgb_masks = np.repeat(masks[:, :, :, np.newaxis], 3, axis=-1)

    original_imT = original_imT.astype(np.float64)
    inpaint_imT = inpaint_imT.astype(np.float64)
    blends = ((1.0 - rgb_masks) * original_imT[np.newaxis] +
              rgb_masks * inpaint_imT[np.newaxis])

    blend_embeds = snet.embeddings(blends.astype(np.float32))
    blend_embeds = blend_embeds / np.linalg.norm(blend_embeds, axis=1,
                                                 keepdims=True)

    pr_dist = np.linalg.norm(blend_embeds - original_gal_embed, axis=1)
    pg_dist = np.linalg.norm(blend_embeds - inpaint_gal_embed, axis=1)

    classified_as_twin = pg_dist < pr_dist
    assert not classified_as_twin[0], (
        "mask-0 blend (pure original) already classifies as the twin")

    if return_transitions:
        return classified_as_twin, pg_dist, pr_dist, blends, masks
    return classified_as_twin, pg_dist, pr_dist


def intersect_over_union_thresholded_saliency(
        saliency_map, ground_truth, mask_threshold_method, percentiles=None,
        thresholds=None, seed=None, include_zero_elements=True,
        return_fpos=False, return_tpos=False):
    """IoU of thresholded saliency vs the inpainting region
    (reference: inpainting_game.py:149-197).

    Computed without materializing the [T,H,W] mask family: every count
    the mask formulation produces is a count of strict ``plane > thr``
    comparisons, so ``sort + searchsorted`` yields the identical
    integers (mask t = ``plane > thr[t]``; #(plane > thr) =
    N - #(plane <= thr))."""
    with span("xfr.eval.iou"):
        ground_truth = ground_truth.astype(bool)
        plane, thr = _threshold_plane(
            saliency_map, mask_threshold_method, percentiles=percentiles,
            thresholds=thresholds, seed=seed,
            include_zero_elements=include_zero_elements)

        flat = plane.ravel()
        all_sorted = np.sort(flat)
        gt_flat = ground_truth.ravel()
        gt_sorted = np.sort(flat[gt_flat])
        mask_cnt = flat.size - np.searchsorted(all_sorted, thr, side="right")
        true_pos = gt_sorted.size - np.searchsorted(gt_sorted, thr,
                                                    side="right")
        n_gt = gt_sorted.size
        union = n_gt + mask_cnt - true_pos
        iou = true_pos / (union + 1e-9)
    ret = (iou,)
    if return_fpos:
        ret += (mask_cnt - true_pos,)
    if return_tpos:
        ret += (true_pos,)
    return ret[0] if len(ret) == 1 else ret


def ratio_mate_nonmate_saliency(saliency_mask, probe_mate_region,
                                of_total=True):
    """Saliency mass ratios in mated vs non-mated regions
    (reference: inpainting_game.py:200-215)."""
    smap_refpart = np.nansum(saliency_mask * probe_mate_region)
    smap_nmpart = np.nansum(saliency_mask * (1.0 - probe_mate_region))
    if not of_total:
        smap_refpart /= np.nansum(probe_mate_region)
        smap_nmpart /= np.nansum(1.0 - probe_mate_region)
    else:
        smap_refpart /= probe_mate_region.size
        smap_nmpart /= probe_mate_region.size
    return smap_refpart, smap_nmpart


def hidinggame_mated_nonmated_regions(smaps, probe_mate_region,
                                      percentiles=np.arange(0, 101),
                                      add_noise=False, of_total=True):
    """Hiding-game ratios across percentiles
    (reference: inpainting_game.py:217-270)."""
    percentiles = np.sort(percentiles)
    refparts, nmparts = {}, {}
    for type_, smap in smaps.items():
        assert np.all(np.invert(np.isnan(smap)))
        if add_noise:
            smap = smap + np.random.rand(*smap.shape) * 1e-9
        thresholds = np.percentile(
            np.append(smap.flatten(), [0.0, 1.0]), 100.0 - percentiles,
            method="higher")
        refparts[type_], nmparts[type_] = [], []
        for thresh, percentile in zip(thresholds, percentiles):
            assert not np.isnan(thresh)
            if not np.isclose(np.mean(smap > thresh) * 100, percentile,
                              atol=1e-2):
                raise RuntimeError(
                    "Failed to find accurate threshold for the top %0.1f%% "
                    "of saliency. This indicates that there is a portion of "
                    "the saliency map with exactly the same value. "
                    "Setting add_noise to True should prevent this."
                    % percentile)
            refpart, nmpart = ratio_mate_nonmate_saliency(
                smap > thresh, probe_mate_region, of_total=of_total)
            refparts[type_].append(refpart)
            nmparts[type_].append(nmpart)
    ref = {i: np.hstack(part) for i, part in refparts.items()}
    nm = {i: np.hstack(part) for i, part in nmparts.items()}
    return ref, nm, percentiles


class HidingGame:
    """Secondary benchmark: score decay as top-saliency pixels are hidden
    (reference: inpainting_game.py:272-310)."""

    def __init__(self, saliency_map, image, masking_fn, scoring_fn,
                 hide_from_max=True, max_hidden_pct=100.0, delta_pct=1.0):
        self.saliency_map = saliency_map
        self.image = image
        self.masking_fn = masking_fn
        self.scoring_fn = scoring_fn
        self.hide_from_max = hide_from_max
        self.max_hidden_pct = max_hidden_pct
        self.delta_pct = delta_pct
        self.masks = None
        self.scores = None

    def generate_masks(self):
        self.num_masks = int(self.max_hidden_pct / self.delta_pct + 1)
        self.sampled_pcts = np.linspace(0, self.max_hidden_pct,
                                        self.num_masks)
        if self.hide_from_max:
            thresholds = np.percentile(self.saliency_map,
                                       self.sampled_pcts[::-1])
        else:
            thresholds = np.percentile(self.saliency_map, self.sampled_pcts)
        self.masks = (self.saliency_map[..., np.newaxis] < thresholds)
        self.masks = self.masks.transpose((2, 0, 1))
        self.masked_images = self.masking_fn(self.masks, self.image)

    def evaluate(self):
        if self.masks is None:
            self.generate_masks()
        self.scores = self.scoring_fn(self.masked_images)
        return self.sampled_pcts, self.scores
