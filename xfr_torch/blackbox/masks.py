"""Sparse mask generation and image filling for STRise (port of
xfr_tpu/blackbox/masks.py).

Everything runs on the tensors' device but the random draws.
Without-replacement sampling is the Gumbel-top-k trick; upsampling is one
batched bilinear resize and shifting a batched crop.  Random numbers come
from an explicit CPU ``torch.Generator`` and are drawn on the host (the
card's Philox and the CPU's Mersenne Twister give other bits for one
seed), then copied to the device: grids are drawn first, then shifts,
from one generator, so one seed gives the same masks on the card and on
the CPU, and whether or not the scorer uses the fused blend kernel.
Torch's generator cannot reproduce the JAX PRNG's bits, so the parity
tests hand both packages the same noise (``sparse_grids_from_noise``) or
the same grids and shifts.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from xfr_torch.utils.device import precision_scope, to_device


def gaussian_blur(img, sigma, truncate=4.0):
    """skimage.filters.gaussian equivalent on the tensor's device: a
    separable gaussian with 'nearest' (edge) padding, in full float32.
    img: [H, W], [H, W, C] with C in (1, 3, 4) (channel-last), or
    [N, H, W]."""
    if sigma <= 0:
        return img
    k = _gaussian_kernel(float(sigma), float(truncate), img.dtype, img.device)
    radius = (k.shape[0] - 1) // 2

    def blur_axis(a, axis):
        a = torch.movedim(a, axis, -1)
        shp = a.shape
        flat = a.reshape(-1, 1, shp[-1])
        padded = F.pad(flat, (radius, radius), mode="replicate")
        # symmetric kernel: correlation == convolution
        out = F.conv1d(padded, k.view(1, 1, -1))
        return torch.movedim(out.reshape(shp), -1, axis).contiguous()

    with precision_scope("highest"):
        # Blur the two spatial axes: [H,W], [H,W,C] (channel-last) or [N,H,W].
        if img.ndim == 2 or (img.ndim == 3 and img.shape[-1] in (1, 3, 4)):
            return blur_axis(blur_axis(img, 0), 1)
        return blur_axis(blur_axis(img, 1), 2)


@functools.lru_cache(maxsize=None)
def _gaussian_kernel(sigma, truncate, dtype, device):
    """The normalized 1-D gaussian of ``sigma`` out to ``truncate`` sigmas,
    built on the host and uploaded once per (sigma, truncate, dtype,
    device) through :func:`to_device`."""
    radius = int(truncate * sigma + 0.5)
    xs = np.arange(-radius, radius + 1)
    k = np.exp(-0.5 * (xs / sigma) ** 2)
    return to_device(torch.as_tensor(k / k.sum(), dtype=dtype), device)


def resize_bilinear(img, shape):
    """jax.image.resize(..., "linear") over the trailing two axes: half-pixel
    centres, clamped edges, and antialiasing where it downsamples (JAX's
    'linear' scales its triangle kernel when shrinking)."""
    shape = tuple(int(s) for s in shape)
    lead, (h, w) = img.shape[:-2], img.shape[-2:]
    down = shape[0] < h or shape[1] < w
    x = img.reshape(-1, 1, h, w)
    out = F.interpolate(x, size=shape, mode="bilinear", align_corners=False,
                        antialias=down)
    return out.reshape(*lead, *shape)


def prior_to_grid(prior, mask_scale, prior_type="mean_ebp", pct=50.0):
    """Prior map [H,W] -> normalized sampling grid [gh,gw]: downscale with
    anti-aliasing, clip below the pct-percentile to zero, optionally
    binarize (uniform prior), normalize to a distribution."""
    h, w = prior.shape
    gh = int(math.ceil(h / mask_scale))
    gw = int(math.ceil(w / mask_scale))
    # anti-aliased downscale (skimage recipe: gaussian with
    # sigma=(factor-1)/2, then interpolate)
    factor = max(h / gh, w / gw)
    sig = max(0.0, (factor - 1) / 2.0)
    blurred = gaussian_blur(prior.float(), sig)
    grid = resize_bilinear(blurred, (gh, gw))

    threshold = torch.quantile(grid.reshape(-1), pct / 100.0)
    grid = torch.where(grid < threshold, torch.zeros_like(grid), grid)
    if prior_type == "uniform":
        grid = (grid > 0).float()
    return grid / torch.sum(grid)


def check_grid_capacity(prior_shape, mask_scale, num_elements, pct=50.0):
    """Static guard for the sparse-mask sampler: the pct-percentile prior
    clip keeps only ~the top (100-pct)% of grid cells, so asking for more
    elements than that makes Gumbel-top-k pick zero-probability cells.

    A quirk of the reference kept as it is: this is only a bound on the
    grid size, not a count of the prior's positive cells (a prior with
    many ties at the percentile can still have fewer)."""
    gh = int(math.ceil(prior_shape[0] / mask_scale))
    gw = int(math.ceil(prior_shape[1] / mask_scale))
    avail = int(math.ceil(gh * gw * (100.0 - pct) / 100.0))
    if num_elements > avail:
        raise ValueError(
            "num_mask_elements=%d exceeds the %dx%d sampling grid's "
            "guaranteed positive cells after the %g%%-percentile prior "
            "clip (~%d): raise mask_scale resolution or lower "
            "num_mask_elements" % (num_elements, gh, gw, pct, avail))


def gumbel_noise(generator, num_masks, num_cells, device):
    """[num_masks, num_cells] standard Gumbel noise, float32, on ``device``:
    -log(-log(U)) with U uniform in [tiny, 1), drawn and transformed on the
    host from ``generator`` (a CPU generator), so that one seed gives the
    same noise on every device."""
    tiny = torch.finfo(torch.float32).tiny
    u = torch.rand((num_masks, num_cells), generator=generator,
                   dtype=torch.float32)
    return to_device(-torch.log(-torch.log(torch.clamp(u, min=tiny))),
                     device)


def sparse_grids_from_noise(grid_probs, gumbel, num_elements):
    """Gumbel-top-k on given noise: [num_masks, gh, gw] binary grids with
    ``num_elements`` zeros each, at the top-k cells of log(p) + noise."""
    gh, gw = grid_probs.shape
    logp = torch.where(grid_probs > 0, torch.log(grid_probs),
                       torch.full_like(grid_probs, float("-inf")))
    _, idx = torch.topk(logp.reshape(1, -1) + gumbel, num_elements, dim=1)
    hit = torch.zeros_like(gumbel).scatter_(1, idx, 1.0)
    return (1.0 - hit).reshape(-1, gh, gw)


def sample_sparse_grids(generator, grid_probs, num_masks, num_elements):
    """[num_masks, gh, gw] binary grids with ``num_elements`` zeros each,
    cells chosen without replacement with probability proportional to
    ``grid_probs``.  Callers should pre-validate with
    :func:`check_grid_capacity`."""
    gh, gw = grid_probs.shape
    noise = gumbel_noise(generator, num_masks, gh * gw, grid_probs.device)
    return sparse_grids_from_noise(grid_probs, noise, num_elements)


def random_shifts(generator, num_masks, mask_scale, device):
    """[num_masks, 2] int32 crop shifts in [0, mask_scale) on ``device``,
    drawn on the host from ``generator`` (a CPU generator)."""
    return to_device(torch.randint(0, mask_scale, (num_masks, 2),
                                   generator=generator, dtype=torch.int32),
                     device)


def upsample_shift_masks_static(grids, shifts, input_size, mask_scale):
    """Bilinear-upsample grids [N,gh,gw] to (input+scale)^2 and crop the
    input_size window at each mask's shift [N,2] (row, col)."""
    H, W = input_size
    big = resize_bilinear(grids, (H + mask_scale, W + mask_scale))
    n, bh, bw = big.shape
    shifts = shifts.long()
    rows = shifts[:, :1] + torch.arange(H, device=big.device)   # [N,H]
    cols = shifts[:, 1:] + torch.arange(W, device=big.device)   # [N,W]
    big = torch.gather(big, 1, rows[:, :, None].expand(n, H, bw))
    return torch.gather(big, 2, cols[:, None, :].expand(n, H, W))


def upsample_shift_masks(generator, grids, input_size, mask_scale,
                         random_shift=True):
    """Bilinear-upsample binary grids to (input+scale)^2 and crop a randomly
    shifted input_size window."""
    if not random_shift:
        return resize_bilinear(grids, tuple(input_size))
    shifts = random_shifts(generator, grids.shape[0], mask_scale,
                           grids.device)
    return upsample_shift_masks_static(grids, shifts, input_size, mask_scale)


def make_masks(generator, prior, num_masks, mask_scale, num_elements,
               prior_type="mean_ebp", random_shift=True, device=None):
    """Full mask pipeline: prior [H,W] -> masks [N,H,W] float in [0,1] on
    ``device`` (default: the prior's).  The sampling grid is computed
    where the prior lies: a prior on the host gives the same grid, so the
    same masks, on every device."""
    # a uniform prior binarizes to all-ones after the clip (every cell
    # equals the percentile), so its capacity is the whole grid
    check_grid_capacity(prior.shape, mask_scale, num_elements,
                        pct=0.0 if prior_type == "uniform" else 50.0)
    grid_probs = to_device(prior_to_grid(prior, mask_scale, prior_type),
                           prior.device if device is None else device)
    grids = sample_sparse_grids(generator, grid_probs, num_masks,
                                num_elements)
    return upsample_shift_masks(generator, grids, prior.shape, mask_scale,
                                random_shift)
