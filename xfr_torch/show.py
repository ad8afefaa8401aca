"""Saliency visualization and result writing (port of xfr_tpu/show.py;
reference: python/xfr/show.py).

jet-colormap overlay blending, TP/FP mask-overlap rendering, and the
skip-if-exists saliency writer that makes generation runs resumable
(the reference's job-level idempotency mechanism, show.py:208-210).
"""

from __future__ import annotations

import os

import numpy as np

from xfr_torch.utils.image import resize as _resize, gaussian as _gaussian

__all__ = [
    "blend_saliency_map",
    "create_save_smap",
    "plotMaskOverlap",
    "processSaliency",
    "ReturnComparison",
    "savefig",
]


def savefig(fn, fig=None, npdata=None, output_dir=None, transparent=False):
    import matplotlib.pyplot as plt

    if output_dir is None:
        output_dir = os.environ["PWEAVE_OUTPUT_DIR"]
    fpath = os.path.join(output_dir, fn)
    try:
        os.remove(fpath)
    except OSError:
        pass
    if fig is None:
        plt.savefig(fpath, transparent=transparent)
    else:
        fig.savefig(fpath, transparent=transparent)
    if npdata is not None:
        np.savez(os.path.join(output_dir, os.path.splitext(fn)[0] + ".npz"),
                 **npdata)


def overlay_saliency(img, smap, overlap=True, blur=False, blur_sigma=0.02,
                     scale_factor=1.0, gamma=0.8):
    """Render one saliency map over one image.

    The map is shifted to zero, peak-normalized, clipped at
    ``scale_factor`` of its peak (then re-normalized so the clip value
    maps to full intensity), and bicubic-resized to the image extents;
    ``blur`` re-normalizes after a Gaussian whose sigma is a fraction of
    the image size.  With ``overlap`` the jet-colored map is alpha-
    composited onto the image with per-pixel weight ``heat**gamma``;
    without it the resized heat map itself is returned.

    Returns None when the map is flat (zero dynamic range — nothing to
    show); callers decide what a missing overlay means.  Output parity
    with the JAX package's renderer is pinned by tests/test_torch_eval.py.
    """
    heat = np.array(smap, np.float64, copy=True)
    heat -= heat.min()
    if not heat.max() > 0:
        return None
    heat /= heat.max()
    heat = np.minimum(heat, scale_factor)
    heat /= scale_factor
    heat = _resize(heat, img.shape[:2], order=3)
    if blur:
        heat = _gaussian(heat, blur_sigma * max(img.shape[:2]))
        heat -= heat.min()
        heat /= heat.max()
    if not overlap:
        return heat
    colors = jet(heat)
    alpha = (heat ** gamma).reshape(heat.shape + (1,))
    return (1 - alpha) * img + alpha * colors


# matplotlib's "jet" segment data: (x, value below x, value above x)
_JET_SEGMENTS = (
    ((0.0, 0, 0), (0.35, 0, 0), (0.66, 1, 1), (0.89, 1, 1), (1.0, 0.5, 0.5)),
    ((0.0, 0, 0), (0.125, 0, 0), (0.375, 1, 1), (0.64, 1, 1), (0.91, 0, 0),
     (1.0, 0, 0)),
    ((0.0, 0.5, 0.5), (0.11, 1, 1), (0.34, 1, 1), (0.65, 0, 0), (1.0, 0, 0)))


def _jet_table(n=256):
    """The n-entry RGB lookup table matplotlib builds from the segments."""
    xind = (n - 1) * np.linspace(0, 1, n)
    cols = []
    for seg in _JET_SEGMENTS:
        x, y0, y1 = np.array(seg, np.float64).T
        x = x * (n - 1)
        ind = np.searchsorted(x, xind)[1:-1]
        distance = (xind[1:-1] - x[ind - 1]) / (x[ind] - x[ind - 1])
        cols.append(np.clip(np.concatenate(
            [[y1[0]], distance * (y0[ind] - y1[ind - 1]) + y1[ind - 1],
             [y0[-1]]]), 0.0, 1.0))
    return np.stack(cols, axis=1)


_JET_LUT = _jet_table()


def jet(x):
    """``matplotlib.cm.jet(x)`` without its alpha channel, for a float
    array, without matplotlib: x scaled by 256 and truncated into the
    256-entry table, values outside [0, 1] clamped to the end colors, NaN
    black."""
    n = _JET_LUT.shape[0]
    xa = np.asarray(x, np.float64) * n
    bad = np.isnan(xa)
    out = _JET_LUT[np.clip(np.where(bad, 0, xa), 0, n - 1).astype(int)]
    out[bad] = 0.0
    return out


def ReturnComparison(imgVec, attMaps, suppressMap=None, overlap=True,
                     blur=False, blur_sigma=0.02, scale_factor=1.0,
                     gamma=0.8):
    """Batch overlay rendering (API name kept for reference parity).

    ``suppressMap`` is updated IN PLACE: an entry flips to 1 where the
    map was flat and the bare image was passed through; entries pre-set
    to nonzero skip rendering entirely.
    """
    if suppressMap is None:
        suppressMap = np.zeros(len(imgVec))
    out_maps = []
    for i, img in enumerate(imgVec):
        rendered = None
        if suppressMap[i] == 0:
            rendered = overlay_saliency(
                img, attMaps[i], overlap=overlap, blur=blur,
                blur_sigma=blur_sigma, scale_factor=scale_factor,
                gamma=gamma)
        if rendered is None:
            suppressMap[i] = 1
            out_maps.append(img)
        else:
            out_maps.append(rendered)
    return out_maps


def blend_saliency_map(image, smap, blur=False, blur_sigma=0.02,
                       scale_factor=1.0, gamma=0.8):
    """Single-image overlay; a flat map passes the image through
    (reference: show.py:46-86)."""
    out = overlay_saliency(image, smap, blur=blur, blur_sigma=blur_sigma,
                           scale_factor=scale_factor, gamma=gamma)
    return image if out is None else out


def processSaliency(img, attMap):
    """Normalize + resize saliency to image extents
    (reference: show.py:131-137).

    Robustness fix over the reference: bicubic upsampling overshoots can
    make a (normalized, non-negative) map slightly negative at sharp
    edges, which breaks the percent-density mass invariant downstream
    (inpainting_game.py:65); clip the ringing."""
    attMap = attMap - attMap.min()
    attMap = attMap / (attMap.max() + 1e-9)
    return np.maximum(_resize(attMap, img.shape[:2], order=3), 0.0)


def plotMaskOverlap(img, mask, smap, method, output_dir, mask_id,
                    percent_threshold=None):
    """TP (green) / FP (red) / FN (gray) overlap rendering
    (reference: show.py:139-178)."""
    import imageio.v2 as imageio

    if mask.ndim == 3:
        mask = mask[:, :, 0]
    mask = mask.astype(bool)
    smap = smap + np.random.rand(*smap.shape) * 1e-9

    if percent_threshold is None:
        fname = "{}/{}-{METHOD}-maskOverlap{SUFFIX}.png".format(
            output_dir, mask_id, METHOD=method, SUFFIX="{SUFFIX}")
        pct = 100 - mask.mean() * 100
    else:
        fname = "{}/{}-{METHOD}-maskOverlap-thresh={thresh}{SUFFIX}.png" \
            .format(output_dir, mask_id, METHOD=method,
                    thresh=percent_threshold, SUFFIX="{SUFFIX}")
        pct = 100 - percent_threshold
    threshold = np.percentile(np.append(smap.flatten(), [0.0, 1.0]), pct,
                              method="higher")

    top_smap = smap > threshold
    img = img / 255.0
    rgb = img * 0.4
    rgb[top_smap & mask] = np.array([0, 1, 0])
    rgb[top_smap & np.invert(mask)] = np.array([1, 0, 0])
    rgb[np.invert(top_smap) & mask] = np.array([0.6, 0.6, 0.6])
    imageio.imwrite(fname.format(SUFFIX=""), (rgb * 255).astype(np.uint8))


def smap_paths(method, output_dir, mask_id):
    """(overlay png, npz) output paths for one saliency map — the single
    source of the naming convention create_save_smap writes and the
    generation pipelines' skip checks read."""
    overlay = "{}/{}-{}-saliency-overlay.png".format(output_dir, mask_id,
                                                     method)
    npz = "{}/{}-{}-saliency.npz".format(output_dir, mask_id, method)
    return overlay, npz


def smap_cached(method, output_dir, mask_id):
    """True when both outputs for this map already exist on disk."""
    overlay, npz = smap_paths(method, output_dir, mask_id)
    return os.path.exists(overlay) and os.path.exists(npz)


def create_save_smap(method, output_dir, overwrite, smap_fn, mask_id,
                     probe_im, probe_info, mask_im):
    """Compute + write saliency overlay png and npz unless cached
    (reference: show.py:196-223)."""
    import imageio.v2 as imageio

    overlay_filename, npz_filename = smap_paths(method, output_dir, mask_id)
    if overwrite or not smap_cached(method, output_dir, mask_id):
        # np.array, not asarray: smap_fn may hand back a read-only view
        # (of a tensor's numpy()); the normalization below is in-place
        smap = np.array(smap_fn(), np.float32)
        smap -= smap.min()
        total = smap.sum()
        if total > 0:
            smap /= total
        # else: a flat map (degenerate probe/classifier) stays all-zero —
        # 0/0 would write an all-NaN npz that downstream analysis
        # consumes silently; a zero map is handled by the game's
        # include_zero_saliency machinery
        smap = processSaliency(probe_im, smap)
        overlay = blend_saliency_map(probe_im, smap)
        imageio.imwrite(overlay_filename,
                        (np.clip(overlay, 0, 1) * 255).astype(np.uint8))
        np.savez_compressed(npz_filename, saliency_map=smap)
        print("Created:\n %s\n" % overlay_filename)
