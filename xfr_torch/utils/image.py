"""Host-side image I/O and geometry utilities (port of
xfr_tpu/utils/image.py).

Resizing uses PIL (bilinear, the dominant mode in the reference), imported
only when a resize actually happens: a 224x224 probe needs no PIL.
Gaussian filtering uses scipy.ndimage.  ``imageio`` is imported only to
read a file and ``pandas`` only when a loader is handed a DataFrame, so a
list of arrays loads where neither is installed.
"""

from __future__ import annotations

import os

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


def gaussian(img, sigma, preserve_range=True, channel_axis=None):
    """skimage.filters.gaussian equivalent (scipy.ndimage, mode='nearest')."""
    from scipy.ndimage import gaussian_filter

    img = np.asarray(img, np.float32)
    if channel_axis is not None or (img.ndim == 3 and img.shape[-1] in (3, 4)):
        sig = [sigma, sigma, 0]
    else:
        sig = sigma
    return gaussian_filter(img, sig, mode="nearest")


def crop_image(img, crop_xywh=None, crop_tblr=None, roi_method="expand"):
    """Square crop around a box."""
    if crop_xywh is not None:
        x = int(round(crop_xywh[0]))
        y = int(round(crop_xywh[1]))
        w = int(round(crop_xywh[2]))
        h = int(round(crop_xywh[3]))
    if crop_tblr is not None:
        y = int(round(crop_tblr[0]))
        y2 = int(round(crop_tblr[1]))
        x = int(round(crop_tblr[2]))
        x2 = int(round(crop_tblr[3]))
        w = y2 - y
        h = x2 - x

    center_x = x + w // 2
    center_y = y + h // 2

    if roi_method == "constrict":
        crop_dim = int(min(w, h))
    elif roi_method == "constrict80":
        crop_dim = int(min(w, h) * 0.8)
    elif roi_method == "constrict50":
        crop_dim = int(min(w, h) * 0.5)
    else:
        assert roi_method == "expand"
        crop_dim = min(max(w, h), min(img.shape[0], img.shape[1]))
    top = max(0, center_y - crop_dim // 2)
    left = max(0, center_x - crop_dim // 2)
    bottom = min(img.shape[0], top + crop_dim)
    right = min(img.shape[1], left + crop_dim)
    top = max(0, min(top, bottom - crop_dim))
    left = max(0, min(left, right - crop_dim))
    return img[top:bottom, left:right, :], (top, bottom, left, right)


def crop_example_no_name(ex, data_root=""):
    """Load + square-crop a DataFrame row."""
    import imageio.v2 as imageio

    img = imageio.imread(os.path.join(data_root, ex["Filename"]))
    img = img.astype(float) / 255
    if img.ndim == 2:
        img = np.repeat(img[:, :, np.newaxis], 3, axis=2)
    try:
        cropped, _ = crop_image(
            img, crop_xywh=(ex["XMin"], ex["YMin"], ex["Width"], ex["Height"]))
    except KeyError:
        cropped = img
    return cropped, ex.get("SubjectID"), ex["Filename"]


def dataframe_image_loader(df):
    for _, row in df.iterrows():
        img, _, _ = crop_example_no_name(row)
        yield img


def _is_dataframe(obj):
    """True for a pandas DataFrame; pandas is imported only when the
    object's class comes from it."""
    if not type(obj).__module__.startswith("pandas"):
        return False
    import pandas as pd

    return isinstance(obj, pd.DataFrame)


def image_loader(images, returnImageIndex=False, returnFileName=False,
                 repeats=1):
    """Iterate displayable float [0,1] HWC images.

    Accepts a DataFrame (with Filename/XMin/... columns), a list of file
    paths, or a list of HxWx3 numpy arrays.
    """
    if _is_dataframe(images):
        for i, (_, imginfo) in enumerate(images.iterrows()):
            img, _, fn = crop_example_no_name(imginfo)
            assert img.max() <= 1.0 and img.min() >= 0.0
            ret = [img]
            if returnImageIndex:
                ret.append(i)
            if returnFileName:
                ret.append(fn)
            if repeats == 1:
                yield ret[0] if len(ret) == 1 else tuple(ret)
            else:
                for repeat_num in range(repeats):
                    yield tuple(ret + [repeat_num])
    else:
        for i, img in enumerate(images):
            if isinstance(img, np.ndarray):
                assert img.ndim == 3 and img.shape[2] == 3
                fn = None
                cropped = img
            elif isinstance(img, str):
                import imageio.v2 as imageio

                fn = img
                img = imageio.imread(fn)
                img = img.astype(float) / 255
                cropped = center_crop(img, convert_uint8=False)
            else:
                raise NotImplementedError("Unhandled type %s" % type(img))
            ret = [cropped]
            if returnImageIndex:
                ret.append(i)
            if returnFileName:
                ret.append(fn)
            if repeats == 1:
                yield ret[0] if len(ret) == 1 else tuple(ret)
            else:
                for repeat_num in range(repeats):
                    yield tuple(ret + [repeat_num])


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
