"""Fused sparse-mask upsample + shift + blend + preprocess for STRise
(port of xfr_tpu/blackbox/pallas_blend.py).

On a CUDA tensor ``fused_mask_blend_preprocess`` launches the hand-written
Hopper kernel ``csrc/fused_blend.cu``, which computes each masked,
mean-subtracted probe straight from the tiny [gh, gw] grid, so the
[N, H, W] float masks never reach device memory.  On a CPU tensor it runs
``fused_mask_blend_preprocess_reference``, the plain PyTorch version of
the same function (materialized masks, then the blend).  There is no
fallback from one to the other.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from xfr_torch.blackbox.masks import upsample_shift_masks_static


def fused_mask_blend_preprocess_reference(grids, shifts, probe, fill, mean,
                                          mask_scale=12):
    """Plain version: [N,gh,gw] grids + [N,2] shifts + [H,W,3] probe/fill +
    [3] mean -> [N,3,H,W] preprocessed masked probes."""
    H, W, _ = probe.shape
    m = upsample_shift_masks_static(grids.float(), shifts, (H, W),
                                    mask_scale)[..., None]
    blend = m * probe.float() + (1.0 - m) * fill.float()
    return (blend - mean.float()).permute(0, 3, 1, 2).contiguous()


def _check(name, t, dtype, ndim, device):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.ndim != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got {t.shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def fused_mask_blend_preprocess(grids, shifts, probe, fill, mean,
                                mask_scale=12):
    """[N,gh,gw] f32 grids + [N,2] int32 shifts (row, col) + [H,W,3] f32
    probe/fill + [3] f32 mean -> [N,3,H,W] f32 preprocessed masked probes.

    CUDA tensors launch the Hopper kernel on the current stream (counted in
    ``fused_mask_blend_preprocess.launches``); CPU tensors run the plain
    version.  Anything else raises."""
    if grids.device.type == "cpu":
        return fused_mask_blend_preprocess_reference(
            grids, shifts, probe, fill, mean, mask_scale)
    if grids.device.type != "cuda":
        raise ValueError(f"unsupported device {grids.device}")
    dev = grids.device
    _check("grids", grids, torch.float32, 3, dev)
    _check("shifts", shifts, torch.int32, 2, dev)
    _check("probe", probe, torch.float32, 3, dev)
    _check("fill", fill, torch.float32, 3, dev)
    _check("mean", mean, torch.float32, 1, dev)
    n, gh, gw = grids.shape
    H, W, C = probe.shape
    if shifts.shape != (n, 2) or C != 3 or fill.shape != probe.shape \
            or mean.shape != (3,):
        raise ValueError(
            f"shape mismatch: grids {tuple(grids.shape)}, shifts "
            f"{tuple(shifts.shape)}, probe {tuple(probe.shape)}, fill "
            f"{tuple(fill.shape)}, mean {tuple(mean.shape)}")
    if n > 65535 or gh * gw > 4096:
        raise ValueError(f"at most 65535 masks of at most 4096 grid cells "
                         f"per launch, got {n} of {gh}x{gw}")
    out = torch.empty((n, 3, H, W), dtype=torch.float32, device=dev)
    if n == 0:
        return out
    # f32 scales of the upsample to (H+s, W+s), as F.interpolate computes
    scale_h = float(np.float32(gh) / np.float32(H + mask_scale))
    scale_w = float(np.float32(gw) / np.float32(W + mask_scale))
    fn = _entry()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(grids.data_ptr(), shifts.data_ptr(), probe.data_ptr(),
                 fill.data_ptr(), mean.data_ptr(), out.data_ptr(), n, gh, gw,
                 H, W, scale_h, scale_w, stream)
    if err != 0:
        raise RuntimeError(f"fused_blend kernel launch failed: CUDA error "
                           f"{err}")
    fused_mask_blend_preprocess.launches += 1
    return out


fused_mask_blend_preprocess.launches = 0


@functools.cache
def _entry():
    """The kernel's C entry, loaded (and built) once, its types set."""
    from xfr_torch import kernels

    fn = kernels.load("fused_blend").fused_mask_blend_preprocess_f32
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [p, p, p, p, p, p, i, i, i, i, i, f, f, p]
    fn.restype = ctypes.c_int
    return fn
