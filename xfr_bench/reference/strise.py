"""Plain reference of one STRise saliency map (stresearch/xfr
``python/xfr/models/strise.py``): the mean-EBP prior, the sparse masks
drawn from it, the blur fill, the masked probes' scores against the
references and the gallery, and the map.

The mask draw is a frozen copy of the measured program's host draw
(``xfr_torch/blackbox/masks.py`` as of this benchmark): one CPU
``torch.Generator`` seeded with the map's seed gives the Gumbel noise of
the grid cells first, then the crop shifts.  The noise is a rule of the
program, not of STRise, so the reference must draw the same to compare
maps; everything the noise feeds (the prior, the sampling grid, the
top-k cells, the upsampled and shifted masks) is computed here again.

Every function works on the tensors' device in their dtype; ``precision``
sets whether convolutions and matrix products may use TF32.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F

from xfr_bench.reference import resnet101_l2 as R


@contextlib.contextmanager
def precision(tf32):
    """TF32 allowed (``tf32``) or not in convolutions and matmuls, for the
    block; the flags are restored after it."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = cudnn.allow_tf32, matmul.allow_tf32
    cudnn.allow_tf32 = matmul.allow_tf32 = bool(tf32)
    try:
        yield
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved


def gaussian_blur(img, sigma, truncate=4.0):
    """skimage.filters.gaussian: a separable gaussian out to ``truncate``
    sigmas with edge ('nearest') padding, over the two spatial axes of
    [H,W] or [H,W,C]."""
    radius = int(truncate * sigma + 0.5)
    xs = np.arange(-radius, radius + 1)
    k = np.exp(-0.5 * (xs / sigma) ** 2)
    k = torch.as_tensor(k / k.sum(), dtype=img.dtype, device=img.device)
    out = img
    for axis in (0, 1):
        a = torch.movedim(out, axis, -1)
        shp = a.shape
        flat = F.pad(a.reshape(-1, 1, shp[-1]), (radius, radius),
                     mode="replicate")
        a = F.conv1d(flat, k.view(1, 1, -1)).reshape(shp)
        out = torch.movedim(a, -1, axis)
    return out.contiguous()


def resize(img, shape):
    """Bilinear resize of the trailing two axes with half-pixel centres,
    antialiased where it shrinks (jax.image.resize 'linear')."""
    lead, (h, w) = img.shape[:-2], img.shape[-2:]
    down = shape[0] < h or shape[1] < w
    out = F.interpolate(img.reshape(-1, 1, h, w), size=tuple(shape),
                        mode="bilinear", align_corners=False, antialias=down)
    return out.reshape(*lead, *shape)


def prior_map(params, cfg, probe_hwc):
    """The mean-EBP prior [224,224]: the channel sum of the MWP at the
    first convolution's output, blurred (sigma 2), clipped at 0,
    normalized to unit mass and resized to the probe's size."""
    x = R.preprocess(probe_hwc[None])
    pooled = R.mean_ebp_conv1(params, cfg, x)[0].sum(0)
    P = torch.clamp(gaussian_blur(pooled, 2.0), min=0.0)
    P = P / torch.clamp(P.sum(), min=1e-16)
    return resize(P, probe_hwc.shape[:2])


def draw_masks(prior, seed, num_masks, scale, elements, pct=50.0):
    """[num_masks, H, W] masks from the prior: the sampling grid (an
    antialiased downscale, clipped below its ``pct`` percentile,
    normalized), ``elements`` cells a mask left out without replacement
    (Gumbel top-k on the frozen host noise), each grid upsampled to
    (H+scale, W+scale) and cropped at its shift."""
    H, W = prior.shape
    gh, gw = math.ceil(H / scale), math.ceil(W / scale)
    sig = max(0.0, (max(H / gh, W / gw) - 1) / 2.0)
    grid = resize(gaussian_blur(prior, sig), (gh, gw))
    thr = torch.quantile(grid.reshape(-1), pct / 100.0)
    grid = torch.where(grid < thr, torch.zeros_like(grid), grid)
    grid = grid / grid.sum()

    gen = torch.Generator()
    gen.manual_seed(int(seed))
    u = torch.rand((num_masks, gh * gw), generator=gen, dtype=torch.float32)
    tiny = torch.finfo(torch.float32).tiny
    gumbel = (-torch.log(-torch.log(torch.clamp(u, min=tiny)))).to(
        prior.device)
    shifts = torch.randint(0, scale, (num_masks, 2), generator=gen,
                           dtype=torch.int32).to(prior.device).long()

    logp = torch.where(grid > 0, torch.log(grid),
                       torch.full_like(grid, float("-inf")))
    _, idx = torch.topk(logp.reshape(1, -1) + gumbel, elements, dim=1)
    grids = 1.0 - torch.zeros_like(gumbel).scatter_(1, idx, 1.0)
    big = resize(grids.reshape(-1, gh, gw), (H + scale, W + scale))
    rows = shifts[:, :1] + torch.arange(H, device=big.device)
    cols = shifts[:, 1:] + torch.arange(W, device=big.device)
    big = torch.gather(big, 1, rows[:, :, None].expand(-1, H, big.shape[2]))
    return torch.gather(big, 2, cols[:, None, :].expand(-1, H, W))


def unit_rows(e):
    return e / torch.linalg.norm(e, dim=1, keepdim=True)


def scores(e, gal):
    """1 - ||e - g|| / 2 of unit rows e [N,D] against unit rows g [G,D]."""
    return 1.0 - 0.5 * torch.cdist(e, gal, compute_mode=
                                   "donot_use_mm_for_euclid_dist")


def _encoder(params, cfg, prec):
    """Unit embeddings of [N,H,W,3] images at a stage precision:
    "float32" (TF32 off), "tf32" (TF32 allowed) or "bfloat16" (weights and
    activations in bfloat16)."""
    if prec == "bfloat16":
        params = {n: {k: v.to(torch.bfloat16) for k, v in p.items()}
                  for n, p in params.items()}

    def embed(images):
        with precision(prec == "tf32"):
            x = R.preprocess(images)
            if prec == "bfloat16":
                x = x.to(torch.bfloat16)
            return unit_rows(R.encode(params, cfg, x).float())

    return embed


# The program's stage precisions, and the precision below each (the
# control's): float32 (TF32 off) -> TF32 -> bfloat16.
LOWER = {"float32": "tf32", "tf32": "bfloat16"}


def saliency_map(params, cfg, probe, refs, gallery, seed, spec,
                 score="float32", lower=False, block=64):
    """STRise's map for one probe, every step from the images: uint8
    [224,224,3] ``probe``, [R,224,224,3] ``refs`` and [G,...] ``gallery``
    on the device.  ``spec``: num_masks, mask_scale, mask_elements,
    blur_fill_pct.  Each stage runs at the program's stated precision: the
    prior, the masks and the fill in float32, the probe's, references' and
    gallery's embeddings with TF32 allowed (the matcher's encode), the
    masked probes' at ``score``; with ``lower`` each one step below.
    Returns {"prior", "cts" [N], "map" [H,W]}."""
    def at(prec):
        return LOWER[prec] if lower else prec

    with precision(at("float32") == "tf32"):
        probe = probe.float()
        prior = prior_map(params, cfg, probe)
        masks = draw_masks(prior, seed, spec["num_masks"],
                           spec["mask_scale"], spec["mask_elements"])
        fill = gaussian_blur(probe, spec["blur_fill_pct"] / 100.0
                             * max(probe.shape))
    embed = _encoder(params, cfg, at("tf32"))
    score_embed = _encoder(params, cfg, at(score))
    ref_e = embed(refs.float())
    gal_e = embed(gallery.float())
    pe = embed(probe[None])
    orig_r, orig_g = scores(pe, ref_e), scores(pe, gal_e)
    cts = []
    with precision(False):
        for i in range(0, masks.shape[0], block):
            m = masks[i:i + block, :, :, None]
            e = score_embed(m * probe + (1.0 - m) * fill)
            cts.append(((orig_r - scores(e, ref_e))
                        - (orig_g - scores(e, gal_e))).mean(1))
        cts = torch.cat(cts)
        sel = (cts > 0).float()
        smap = 1.0 - torch.einsum("n,nhw->hw", cts * sel, masks) \
            / torch.clamp(sel.sum(), min=1.0)
        smap = smap - smap.min()
        smap = smap / smap.max()
    return {"prior": prior, "cts": cts, "map": smap}
