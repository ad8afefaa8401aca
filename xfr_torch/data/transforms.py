"""Image preprocessing / augmentation pipelines (port of
xfr_tpu/data/transforms.py).

PIL + numpy implementations (no torchvision): resize/crop/flip/jitter
pipelines, the two-crop x three-scale x flip evaluation ensemble, blur and
JPEG-artifact distortions.  Pipelines end in a net-specific preprocess fn
(e.g. xfr_torch.models.resnet101.preprocess_resnet101) producing device
tensors.  The PIL and numpy steps are the JAX package's code, so a seeded
pipeline gives the same images in both packages.
"""

from __future__ import annotations

import io

import numpy as np
import PIL.Image
import PIL.ImageFilter
import PIL.ImageOps
import PIL.ImageEnhance


def _resize_short(img, size):
    w, h = img.size
    scale = size / min(w, h)
    return img.resize((max(size, int(round(w * scale))),
                       max(size, int(round(h * scale)))),
                      PIL.Image.BILINEAR)


def _center_crop(img, size=(224, 224)):
    w, h = img.size
    left, top = (w - size[0]) // 2, (h - size[1]) // 2
    return img.crop((left, top, left + size[0], top + size[1]))


def _random_crop(img, size, rng):
    w, h = img.size
    left = rng.randint(0, max(1, w - size[0] + 1))
    top = rng.randint(0, max(1, h - size[1] + 1))
    return img.crop((left, top, left + size[0], top + size[1]))


def _adjust_hue(img, factor):
    """torchvision-style hue shift: rotate the HSV hue channel by
    ``factor`` of a full turn (functional.adjust_hue's PIL path).

    Quirk kept from the JAX package: the shift is ``round(factor * 255)``,
    where torchvision truncates toward zero
    (``np.array(factor * 255).astype(np.uint8)``), so a shift with a
    fraction of half a step or more moves one step further here."""
    h, s, v = img.convert("HSV").split()
    shift = int(round(factor * 255.0))
    h = h.point(lambda x: (x + shift) % 256)
    return PIL.Image.merge("HSV", (h, s, v)).convert("RGB")


def _color_jitter(img, rng, brightness=0.1, contrast=0.1, saturation=0.1,
                  hue=0.1):
    for enh, amount in ((PIL.ImageEnhance.Brightness, brightness),
                        (PIL.ImageEnhance.Contrast, contrast),
                        (PIL.ImageEnhance.Color, saturation)):
        f = 1.0 + rng.uniform(-amount, amount)
        img = enh(img).enhance(f)
    if hue:
        # ColorJitter's hue=0.1, as in the JAX package
        img = _adjust_hue(img, rng.uniform(-hue, hue))
    return img


def compose(*fns):
    def run(img):
        for f in fns:
            img = f(img)
        return img
    return run


def prepare_image_fn(jitter=False, blur_radius=None, blur_prob=1.0,
                     seed=None):
    """Resize-256 + (random or center) crop-224 (+ optional jitter/blur)."""
    rng = np.random.RandomState(seed)

    def run(img):
        img = _resize_short(img.convert("RGB"), 256)
        if jitter:
            img = _random_crop(img, (224, 224), rng)
            if rng.rand() < 0.5:
                img = PIL.ImageOps.mirror(img)
            img = _color_jitter(img, rng)
        else:
            img = _center_crop(img)
        if blur_radius is not None and blur_prob > 0 and \
                rng.rand() < blur_prob and blur_radius > 0:
            img = img.filter(PIL.ImageFilter.GaussianBlur(
                radius=blur_radius))
        return img
    return run


def generate_twocrop_ensemble():
    """Two-crop x 3-scale x flip ensemble: 6 images per input."""
    def twocrop_ensemble(img):
        crops = []
        for size in (230, 256, 282):
            c = _center_crop(_resize_short(img.convert("RGB"), size))
            crops.extend([c, PIL.ImageOps.mirror(c)])
        return tuple(crops)
    return twocrop_ensemble


def generate_random_blur(blur_radius, blur_prob, seed=None):
    rng = np.random.RandomState(seed)

    def random_blur(img):
        if rng.rand() < blur_prob and blur_radius and blur_radius > 0:
            return img.filter(PIL.ImageFilter.GaussianBlur(
                radius=blur_radius))
        return img
    return random_blur


def generate_induce_artifacts(jpeg_quality_range, scale_factor_range,
                              seed=None):
    """Downscale + JPEG-recompress + upscale distortion."""
    assert len(jpeg_quality_range) == 2
    assert all(1 <= v <= 100 for v in jpeg_quality_range)
    assert jpeg_quality_range[0] <= jpeg_quality_range[1]
    assert len(scale_factor_range) == 2
    assert all(0 < v <= 1 for v in scale_factor_range)
    assert scale_factor_range[0] <= scale_factor_range[1]
    log_min, log_max = np.log(scale_factor_range)
    rng = np.random.RandomState(seed)

    def induce_artifacts(img):
        scale = float(np.exp(rng.uniform(log_min, log_max)))
        quality = int(rng.uniform(*jpeg_quality_range))
        small = img.resize((int(img.size[0] * scale),
                            int(img.size[1] * scale)))
        f = io.BytesIO()
        small.save(f, format="JPEG", quality=quality)
        return PIL.Image.open(f).resize(img.size)
    return induce_artifacts


def create_transforms(net_preproc_fn, transform, jitter, blur_radius=None,
                      seed=None):
    """Named pipeline factory."""
    prep = prepare_image_fn(jitter=jitter, seed=seed)
    gray = lambda img: img.convert("L").convert("RGB")
    if transform == "minimal":
        return compose(prep, net_preproc_fn)
    elif transform == "grayscale":
        return compose(prep, gray, net_preproc_fn)
    elif transform == "invert-grayscale":
        return compose(prep, lambda im: PIL.ImageOps.invert(im), gray,
                       net_preproc_fn)
    elif transform == "blur-grayscale":
        return compose(prep, generate_random_blur(blur_radius, 1.0, seed),
                       gray, net_preproc_fn)
    raise RuntimeError("Unknown transform %s" % transform)


def preprocess_with_artifacts(net_preproc_fn, jpeg_quality_range,
                              scale_factor_range, jitter=True, seed=None):
    return compose(prepare_image_fn(jitter=jitter, seed=seed),
                   generate_induce_artifacts(jpeg_quality_range,
                                             scale_factor_range, seed),
                   net_preproc_fn)


def resnet101v4_preprocess_twocrop_ensemble(device="cuda"):
    """6 preprocessed crops per image as one [6,3,224,224] float32 tensor
    on ``device`` (default the card; raises without one)."""
    import torch

    from xfr_torch.models.resnet101 import preprocess_resnet101

    crop_fn = generate_twocrop_ensemble()

    def crop_and_convert(img):
        return torch.cat([preprocess_resnet101(c, device=device)
                          for c in crop_fn(img)])
    return crop_and_convert
