"""VGGFace VGG-16 encoder (legacy, 4096-d fc7) as graph IR (port of
xfr_tpu/models/vggface.py).

Encode = L2-normalized relu(fc7); classify = fc8(dropout(relu(fc7))).
The ReLU/MaxPool/Dropout modules are shared instances in torch (hooked per
call); maxpool is ceil_mode=True; dropout is identity at eval.  The
factory has no VGG-16 branch, as the JAX package's has none.
"""

from __future__ import annotations

import numpy as np
import torch

from xfr_torch.graph import GraphBuilder

MEAN_BGR = np.array([93.5940, 104.7624, 129.1863])  # applied in BGR order

_CFG = ((2, 64), (2, 128), (3, 256), (3, 512), (3, 512))


def build_vgg16(num_classes=2622, cfg=None, input_hw=224, fc_dim=4096):
    """Returns (graph, param_shapes, encode_tensor), the encode tensor
    being the L2-normalized relu(fc7).

    ``cfg``/``input_hw``/``fc_dim`` default to VGG-16; reduced values build
    a structurally identical graph (same op/event sequence) for fast
    parity tests.
    """
    cfg = _CFG if cfg is None else tuple(cfg)
    hw = input_hw
    for _ in cfg:
        hw = -(-hw // 2)  # ceil_mode maxpool halving
    flat = cfg[-1][1] * hw * hw

    g = GraphBuilder("vggface16")
    x = 0
    cin = 3
    for bi, (n, cout) in enumerate(cfg, start=1):
        for ci in range(1, n + 1):
            x = g.conv2d(x, cin, cout, 3, padding=1, name=f"conv{bi}_{ci}")
            x = g.relu(x)
            cin = cout
        x = g.maxpool2d(x, 2, ceil_mode=True)
    x = g.flatten(x)
    x = g.linear(x, flat, fc_dim, name="fc6")
    x = g.relu(x)
    # nn.Dropout is a hooked module in torch (identity at eval)
    x = g.node("dropout_eval", (x,), hooked=True, tag="Dropout")
    x = g.linear(x, fc_dim, fc_dim, name="fc7")
    x = g.relu(x)
    enc = g.l2normalize(x)
    x2 = g.node("dropout_eval", (x,), hooked=True, tag="Dropout")
    out = g.linear(x2, fc_dim, num_classes, name="fc8")
    graph = g.finalize(out)
    return graph, g.param_shapes, enc


def preprocess_vggface(im, device="cuda"):
    """PIL/array RGB -> [1,3,224,224] BGR mean-subtracted float32 tensor on
    ``device`` ("cuda" raises without a card): resize the shortest side to
    256, center-crop 224."""
    import PIL.Image

    from xfr_torch.utils.device import resolve_device

    device = resolve_device(device)
    if not isinstance(im, PIL.Image.Image):
        im = PIL.Image.fromarray(np.asarray(im))
    im = im.convert("RGB")
    w, h = im.size
    scale = 256.0 / min(w, h)
    im = im.resize((int(round(w * scale)), int(round(h * scale))),
                   PIL.Image.BILINEAR)
    w, h = im.size
    left, top = (w - 224) // 2, (h - 224) // 2
    im = im.crop((left, top, left + 224, top + 224))
    bgr = np.asarray(im, np.float64)[..., [2, 1, 0]] - MEAN_BGR
    return torch.as_tensor(np.rollaxis(bgr, 2, 0)[None], dtype=torch.float32,
                           device=device)
