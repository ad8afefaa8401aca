"""LightCNN-29 v2 max-feature-map face matcher as graph IR (port of
xfr_tpu/models/lightcnn.py).

mfm conv blocks (Conv2d(2C) -> Split -> torch.max) with residual mfm
blocks, and pooling as hooked MaxPool2d + AvgPool2d module pairs summed
functionally.  Grayscale 128x128 input; 256-d embedding from the
pre-dropout fc output.
"""

from __future__ import annotations

import numpy as np
import torch

from xfr_torch.graph import GraphBuilder

# Calibration constants of the published matcher.
LIGHTCNN_MATCH_THRESHOLD = 0.829200
LIGHTCNN_PLATTS_SCALING = 10.877741

# skimage.color.rgb2gray luminance weights.
_GRAY = np.array([0.2125, 0.7154, 0.0721])


def build_lightcnn29v2(num_classes=80013, layers=(1, 2, 3, 4)):
    """Returns (graph, param_shapes, encode_tensor)."""
    g = GraphBuilder("lightcnn29v2")

    def mfm(x, cin, cout, k, s, p, name):
        return g.mfm_conv(x, cin, cout, k, stride=s, padding=p,
                          name=f"{name}.filter")

    def resblock(x, c, prefix):
        # two mfm convs + the Add module
        y = mfm(x, c, c, 3, 1, 1, f"{prefix}.conv1")
        y = mfm(y, c, c, 3, 1, 1, f"{prefix}.conv2")
        return g.add(y, x)

    def group(x, cin, cout, prefix):
        x = mfm(x, cin, cin, 1, 1, 0, f"{prefix}.conv_a")
        return mfm(x, cin, cout, 3, 1, 1, f"{prefix}.conv")

    def poolpair(x):
        # maxpool(2) + avgpool(2), both hooked modules, '+' functional
        a = g.maxpool2d(x, 2)
        b = g.avgpool2d(x, 2)
        return g.funcadd(a, b)

    x = mfm(0, 1, 48, 5, 1, 2, "conv1")
    x = poolpair(x)
    for i in range(layers[0]):
        x = resblock(x, 48, f"block1.{i}")
    x = group(x, 48, 96, "group1")
    x = poolpair(x)
    for i in range(layers[1]):
        x = resblock(x, 96, f"block2.{i}")
    x = group(x, 96, 192, "group2")
    x = poolpair(x)
    for i in range(layers[2]):
        x = resblock(x, 192, f"block3.{i}")
    x = group(x, 192, 128, "group3")
    for i in range(layers[3]):
        x = resblock(x, 128, f"block4.{i}")
    x = group(x, 128, 128, "group4")
    x = poolpair(x)
    x = g.flatten(x)
    enc = g.linear(x, 8 * 8 * 128, 256, name="fc")
    x = g.dropout_eval(enc)
    out = g.linear(x, 256, num_classes, bias=False, name="fc2")
    graph = g.finalize(out)
    return graph, g.param_shapes, enc


def preprocess_lightcnn(im, device="cuda"):
    """PIL/array RGB image -> [1,1,128,128] grayscale float32 tensor on
    ``device`` ("cuda" raises without a card): resize the shortest side to
    144 (PIL bilinear), center-crop 128, luminance."""
    import PIL.Image

    from xfr_torch.utils.device import resolve_device

    device = resolve_device(device)
    if not isinstance(im, PIL.Image.Image):
        arr = np.asarray(im)
        if arr.dtype != np.uint8:
            arr = (np.clip(arr, 0, 1) * 255).astype(np.uint8) \
                if arr.max() <= 1.001 else arr.astype(np.uint8)
        im = PIL.Image.fromarray(arr)
    im = im.convert("RGB")
    w, h = im.size
    scale = 144.0 / min(w, h)
    im = im.resize((int(round(w * scale)), int(round(h * scale))),
                   PIL.Image.BILINEAR)
    w, h = im.size
    left, top = (w - 128) // 2, (h - 128) // 2
    im = im.crop((left, top, left + 128, top + 128))
    arr = np.asarray(im, np.float64) / 255.0
    gray = arr @ _GRAY
    return torch.as_tensor(gray[None, None], dtype=torch.float32,
                           device=device)


def preprocess_lightcnn_batch(images):
    """Batched preprocessing on the images' device: [N,H,W,3] float [0,1]
    RGB tensor -> [N,1,H,W] grayscale."""
    gray = images @ torch.as_tensor(_GRAY, dtype=images.dtype,
                                    device=images.device)
    return gray[:, None]
