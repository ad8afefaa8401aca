"""VGGFace2 matchers: ResNet-50-128d and SENet-50-256d as graph IR (port
of xfr_tpu/models/vggface2.py).

Flat MMdnn-converted nets: bias-free convs + BN, inplace ReLU modules,
*functional* torch.add residuals (unhooked), ceil-mode maxpool, AvgPool7
head and a 1x1 feat_extract conv producing the embedding.  SENet adds
squeeze-excite branches (global pool -> 1x1 down -> relu -> 1x1 up ->
Sigmoid -> broadcast scale); the Sigmoid makes SENet unsupported for EBP
(the walk raises on it), but the encode path works, and STRise scores its
masked probes with it on the card (a blackbox map is the only one SENet
gets).

The 2-class triplet classifier lives *outside* the hooked net, so the
final linear here is an unhooked node named 'fc1'.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from xfr_torch.graph import GraphBuilder
from xfr_torch.utils.device import to_device

MEAN_BGRISH = np.array([131.0912, 103.8827, 91.4953])  # RGB order

# Calibration constants of the published matcher.
VGGFACE2_MATCH_THRESHOLD = 0.896200
VGGFACE2_PLATTS_SCALING = 15.921608

# (stage, planes, channels out, stride); the published blocks a stage are
# (3, 4, 6, 3)
_STAGES = (("conv2", 64, 256, 1), ("conv3", 128, 512, 2),
           ("conv4", 256, 1024, 2), ("conv5", 512, 2048, 2))


def _build_vggface2(name, embed_dim, num_classes, se_ratio=None,
                    layers=(3, 4, 6, 3)):
    g = GraphBuilder(name)
    x = g.conv2d(0, 3, 64, 7, stride=2, padding=3, bias=False,
                 name="conv1_7x7_s2")
    x = g.batchnorm2d(x, 64, name="conv1_7x7_s2_bn")
    x = g.relu(x, inplace=True)
    x = g.maxpool2d(x, 3, stride=2, ceil_mode=True)

    cin = 64
    for (stage, planes, cout, stride), nblocks in zip(_STAGES, layers):
        for b in range(1, nblocks + 1):
            pfx = f"{stage}_{b}"
            s = stride if b == 1 else 1
            y = g.conv2d(x, cin, planes, 1, stride=s, bias=False,
                         name=f"{pfx}_1x1_reduce")
            y = g.batchnorm2d(y, planes, name=f"{pfx}_1x1_reduce_bn")
            y = g.relu(y, inplace=True)
            y = g.conv2d(y, planes, planes, 3, padding=1, bias=False,
                         name=f"{pfx}_3x3")
            y = g.batchnorm2d(y, planes, name=f"{pfx}_3x3_bn")
            y = g.relu(y, inplace=True)
            y = g.conv2d(y, planes, cout, 1, bias=False,
                         name=f"{pfx}_1x1_increase")
            y = g.batchnorm2d(y, cout, name=f"{pfx}_1x1_increase_bn")

            if se_ratio is not None:
                # squeeze-excite branch, in the net's call order
                se = g.node("global_avgpool2d", (y,))
                se = g.conv2d(se, cout, cout // se_ratio, 1, bias=True,
                              name=f"{pfx}_1x1_down")
                se = g.relu(se, inplace=True)
                se = g.conv2d(se, cout // se_ratio, cout, 1, bias=True,
                              name=f"{pfx}_1x1_up")
                se = g.node("sigmoid", (se,))
                y = g.node("mul", (se, y), hooked=False, tag="FuncMul")

            if b == 1:
                r = g.conv2d(x, cin, cout, 1, stride=s, bias=False,
                             name=f"{pfx}_1x1_proj")
                r = g.batchnorm2d(r, cout, name=f"{pfx}_1x1_proj_bn")
            else:
                r = x
            # functional torch.add(residual, main): unhooked
            x = g.node("add", (r, y) if se_ratio is None else (y, r),
                       hooked=False, tag="FuncAdd")
            x = g.relu(x, inplace=True)
            cin = cout

    x = g.avgpool2d(x, 7, stride=1)
    x = g.conv2d(x, 2048, embed_dim, 1, bias=False, name="feat_extract")
    enc = g.flatten(x)
    # the external triplet classifier (unhooked)
    out = g.node("linear", (enc,), hooked=False, pname="fc1")
    g.param_shapes["fc1"] = {"w": (num_classes, embed_dim)}
    graph = g.finalize(out)
    return graph, g.param_shapes, enc


def build_resnet50_128(num_classes=2, layers=(3, 4, 6, 3)):
    """VGGFace2 ResNet-50 with 128-d embedding; ``layers``: blocks a
    stage (fewer for small tests)."""
    return _build_vggface2("resnet50_128", 128, num_classes, layers=layers)


def build_senet50_256(num_classes=2, layers=(3, 4, 6, 3)):
    """VGGFace2 SENet-50 with 256-d embedding (EBP-unsupported: Sigmoid);
    ``layers``: blocks a stage (fewer for small tests)."""
    return _build_vggface2("senet50_256", 256, num_classes, se_ratio=16,
                           layers=layers)


def preprocess_vggface2(img, device="cuda"):
    """PIL/array RGB -> [1,3,224,224] float32 tensor on ``device`` ("cuda"
    raises without a card): shortest-side-224 bilinear resize (sizes
    rounded up), center crop, mean subtract."""
    import PIL.Image

    from xfr_torch.utils.device import resolve_device

    device = resolve_device(device)
    if not isinstance(img, PIL.Image.Image):
        img = PIL.Image.fromarray(np.asarray(img))
    img = img.convert("RGB")
    w, h = img.size
    ratio = 224.0 / min(w, h)
    img = img.resize((int(np.ceil(w * ratio)), int(np.ceil(h * ratio))),
                     PIL.Image.BILINEAR)
    x = np.array(img)
    h_start = (x.shape[0] - 224) // 2
    w_start = (x.shape[1] - 224) // 2
    x = x[h_start:h_start + 224, w_start:w_start + 224]
    x = x - MEAN_BGRISH
    return torch.as_tensor(x.transpose(2, 0, 1)[None], dtype=torch.float32,
                           device=device)


@functools.lru_cache(maxsize=None)
def mean_vggface2(dtype, device):
    """MEAN_BGRISH as a [3] tensor of ``dtype`` on ``device``, uploaded
    once per (dtype, device) and without waiting for the card."""
    return to_device(torch.as_tensor(MEAN_BGRISH, dtype=dtype), device)


def preprocess_vggface2_batch(images):
    """Batched preprocessing on the images' device: [N,H,W,3] RGB [0,255]
    tensor -> [N,3,H,W] mean-subtracted."""
    return (images - mean_vggface2(images.dtype, images.device)).permute(
        0, 3, 1, 2)
