"""STR-Janus ResNet-101 + L2 face matcher ("resnetv4/v6") as graph IR
(port of xfr_tpu/models/resnet101.py).

  conv7x7/s2 -> bn -> relu -> maxpool3/s2 ->
  4 bottleneck stages [3,4,23,3] (1x1/3x3/1x1 convs with bias, explicit
  Add module for the residual) with the parameter-free downsample
  AvgPool(k=s)+ConcatChannels zero padding -> avgpool7 ->
  fc1(2048->512) -> F.normalize -> Multiply(50) -> fc2(512->num_classes).

Parameter names equal the torch state_dict prefixes so checkpoint
conversion is mechanical (models/convert.py).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from xfr_torch.graph import GraphBuilder
from xfr_torch.utils.device import to_device

MEAN_RGB = np.array([122.782, 117.001, 104.298])

# Calibration constants of the published matchers.
RESNETV6_MATCH_THRESHOLD = 0.9636
RESNETV6_PLATTS_SCALING = 15.05
RESNETV4_MATCH_THRESHOLD = 0.9722
RESNETV4_PLATTS_SCALING = 16.61


def build_resnet101(num_classes=65359, layers=(3, 4, 23, 3)):
    """Returns (graph, param_shapes, encode_tensor).

    ``encode_tensor`` is the Multiply(50)(L2-normalized fc1) output — the
    reference 'encode' mode result.
    """
    g = GraphBuilder("resnet101")
    x = g.conv2d(0, 3, 64, 7, stride=2, padding=3, name="conv1")
    x = g.batchnorm2d(x, 64, name="bn1")
    x = g.relu(x, inplace=True)
    x = g.maxpool2d(x, 3, stride=2, padding=1)

    inplanes = 64

    def bottleneck(x, inplanes, planes, stride, prefix, with_downsample):
        # call order mirrors Bottleneck.forward
        y = g.conv2d(x, inplanes, planes, 1, stride=stride,
                     name=f"{prefix}.conv1")
        y = g.batchnorm2d(y, planes, name=f"{prefix}.bn1")
        y = g.relu(y, inplace=True)
        y = g.conv2d(y, planes, planes, 3, padding=1, name=f"{prefix}.conv2")
        y = g.batchnorm2d(y, planes, name=f"{prefix}.bn2")
        y = g.relu(y, inplace=True)
        y = g.conv2d(y, planes, planes * 4, 1, name=f"{prefix}.conv3")
        y = g.batchnorm2d(y, planes * 4, name=f"{prefix}.bn3")
        if with_downsample:
            r = g.avgpool2d(x, stride, stride=stride)
            r = g.concat_zero_channels(r, planes * 4 // inplanes - 1)
        else:
            r = x
        y = g.add(y, r)
        return g.relu(y, inplace=True)

    for li, (planes, blocks, stride) in enumerate(
            zip((64, 128, 256, 512), layers, (1, 2, 2, 2))):
        for bi in range(blocks):
            s = stride if bi == 0 else 1
            with_ds = bi == 0 and (s != 1 or inplanes != planes * 4)
            x = bottleneck(x, inplanes, planes, s,
                           f"layer{li + 1}.{bi}", with_ds)
            inplanes = planes * 4

    x = g.avgpool2d(x, 7, stride=7)
    x = g.flatten(x)
    x = g.linear(x, inplanes, 512, name="fc1")
    x = g.l2normalize(x)
    enc = g.multiply_const(x, 50.0)
    out = g.linear(enc, 512, num_classes, name="fc2")
    graph = g.finalize(out)
    return graph, g.param_shapes, enc


def preprocess_resnet101(im, device="cuda"):
    """PIL image or HWC array -> [1,3,224,224] float32 tensor on ``device``
    ("cuda" raises without a card): resize 224, subtract the mean RGB."""
    import PIL.Image

    from xfr_torch.utils.device import resolve_device

    device = resolve_device(device)
    if not isinstance(im, PIL.Image.Image):
        im = PIL.Image.fromarray(np.asarray(im))
    im = im.convert("RGB").resize((224, 224))
    arr = np.asarray(im, np.float64) - MEAN_RGB
    return torch.as_tensor(np.moveaxis(arr, 2, 0)[None], dtype=torch.float32,
                           device=device)


@functools.lru_cache(maxsize=None)
def mean_rgb(dtype, device):
    """MEAN_RGB as a [3] tensor of ``dtype`` on ``device``, uploaded once
    per (dtype, device) and without waiting for the card."""
    return to_device(torch.as_tensor(MEAN_RGB, dtype=dtype), device)


def preprocess_resnet101_batch(images):
    """Batched preprocessing on the images' device: [N,H,W,3] float [0,255]
    RGB tensor -> [N,3,H,W] mean-subtracted."""
    return (images - mean_rgb(images.dtype, images.device)).permute(0, 3, 1, 2)
