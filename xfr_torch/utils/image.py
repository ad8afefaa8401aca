"""Host-side image geometry utilities (port of ``resize`` and
``center_crop`` of xfr_tpu/utils/image.py; the loaders wait for the eval
stage).

Resizing uses PIL (bilinear, the dominant mode in the reference), imported
only when a resize actually happens: a 224x224 probe needs no PIL.
"""

from __future__ import annotations

import numpy as np


def resize(img, shape, order=1, preserve_range=True, anti_aliasing=None,
           clip=True):
    """skimage.transform.resize-style float resize via PIL.

    img: HxW or HxWxC float (any range) or uint8 array.
    shape: (out_h, out_w).
    order: 0 (nearest), 1 (bilinear), 3 (bicubic).
    clip: clamp the output to the input's [min, max] (skimage's default);
        a no-op for order 0/1.
    """
    img = np.asarray(img)
    out_h, out_w = int(shape[0]), int(shape[1])
    if img.shape[:2] == (out_h, out_w):
        out = img.astype(np.float32) if img.dtype != np.float64 else img
        out = np.array(out, copy=True)
        # same normalization as the resized path below — the early
        # return must not change output SCALE with target shape
        if not preserve_range and img.dtype == np.uint8:
            out = out / 255.0
        return out

    import PIL.Image

    resample = {0: PIL.Image.NEAREST, 1: PIL.Image.BILINEAR,
                3: PIL.Image.BICUBIC}[order]

    def _one(ch):
        pim = PIL.Image.fromarray(np.ascontiguousarray(ch, np.float32),
                                  mode="F")
        return np.asarray(pim.resize((out_w, out_h), resample=resample),
                          np.float32)

    if img.ndim == 2:
        out = _one(img)
    else:
        out = np.stack([_one(img[..., c]) for c in range(img.shape[-1])],
                       axis=-1)
    if clip and order not in (0, 1):
        out = np.clip(out, float(img.min()), float(img.max()))
    if not preserve_range and img.dtype == np.uint8:
        out = out / 255.0
    return out


def center_crop(img, convert_uint8=True):
    """Center square crop + resize to 224."""
    if isinstance(img, str):
        import imageio.v2 as imageio
        img = imageio.imread(img)

    img = np.asarray(img)
    if convert_uint8 and img.dtype != np.uint8:
        if img.max() <= 1:
            img = img.copy() * 255
        img = img.astype(np.uint8)
        assert img.max() > 1

    min_dim = min(img.shape[:2])
    yx = (np.asarray(img.shape[:2]) - min_dim) // 2
    img = img[yx[0]:yx[0] + min_dim, yx[1]:yx[1] + min_dim]
    out = resize(img, (224, 224))
    return out.astype(img.dtype)
