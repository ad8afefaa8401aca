"""Plain PyTorch reference of the VGGFace2 SENet-50-256 matcher.

Written from the published network (Cao et al., arXiv:1710.08092, the
ox-vgg/vgg_face2 ``senet50_256_pytorch`` model, as stresearch/xfr loads
it from ``models/senet50_256_pytorch/senet50_256.py``; squeeze-excite
blocks of Hu et al., arXiv:1709.01507): a 7x7/2 stem convolution without
bias, BatchNorm and ReLU, a 3x3/2 max pool in ceil mode, four stages of
[3, 4, 6, 3] Caffe-style bottlenecks (the stride on the first 1x1
reduce, convolutions without bias, each followed by BatchNorm; a 1x1
projection with BatchNorm on each stage's first block), and in every
block a squeeze-excite gate on the block's output before the residual
add: the global average pool, a 1x1 convolution with bias down to
channels / 16, ReLU, a 1x1 convolution with bias back up, Sigmoid, and
the output scaled channel by channel.  Then ReLU of the sum, a 7x7
average pool and the 1x1 ``feat_extract`` convolution to the 256-d
embedding.  It reads a ``{name: {key: tensor}}`` parameter dict under
the converted model's layer names.

Departures from the published description, each the benchmark's:

- ``param_shapes`` also names ``fc1``, xfr's external 2-class triplet
  classifier, which the encode never reads: the program's template has
  it, and the weights are made from one template for both sides.
- The input is RGB less ``MEAN_BGRISH`` channel by channel, as xfr
  preprocesses the converted model's input (``preprocess``).
- ``flat_gates`` (the mechanism's control) replaces each gate by its
  mean over the channels, so every channel of a block is scaled alike.
- ``calibrate`` (``calibrate_gates`` to the configuration's
  ``se_logit_std``, which ``harness.weights`` calls) scales the
  excitation's weights after the random init (the configuration's
  ``assumed``): at the benchmark's plain init the gate logits spread by
  tens across channels, so every gate sits at 0 or 1, a hard channel mask
  that float32 rounding never moves; a trained gate spans most of (0, 1)
  (Hu et al., section 6.4).

It imports nothing of the measured program.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from xfr_bench.reference.strise import precision

# the published BGR mean, in RGB order (xfr's ``MEAN_BGRISH``)
MEAN_BGRISH = (131.0912, 103.8827, 91.4953)

# (stage, planes, channels out, stride)
STAGES = (("conv2", 64, 256, 1), ("conv3", 128, 512, 2),
          ("conv4", 256, 1024, 2), ("conv5", 512, 2048, 2))


def block_plan(cfg):
    """[(prefix, channels in, planes, channels out, stride, projection)]
    of every bottleneck, in call order."""
    plan, cin = [], 64
    for (stage, planes, cout, stride), blocks in zip(STAGES, cfg["layers"]):
        for b in range(1, blocks + 1):
            plan.append((f"{stage}_{b}", cin, planes, cout,
                         stride if b == 1 else 1, b == 1))
            cin = cout
    return plan


def _conv(params, name, x, stride=1, padding=0):
    p = params[name]
    return F.conv2d(x, p["w"], p.get("b"), stride, padding)


def _bn(params, name, x, eps):
    p = params[name]
    return F.batch_norm(x, p["mean"], p["var"], p["gamma"], p["beta"],
                        False, 0.0, eps)


def gate_logits(params, prefix, y):
    """The excitation's [N, C] logits of a block's output y [N,C,H,W]."""
    s = y.mean(dim=(2, 3), keepdim=True)
    s = F.relu(_conv(params, f"{prefix}_1x1_down", s))
    return _conv(params, f"{prefix}_1x1_up", s)[:, :, 0, 0]


def network(params, cfg, x, flat_gates=False, at_gate=None):
    """[N,3,224,224] -> [N,256] embeddings.  ``at_gate(prefix, logits)``,
    where given, sees each block's gate logits and returns those used."""
    eps = cfg["bn_eps"]
    x = F.relu(_bn(params, "conv1_7x7_s2_bn",
                   _conv(params, "conv1_7x7_s2", x, 2, 3), eps))
    x = F.max_pool2d(x, 3, 2, ceil_mode=True)
    for prefix, _, _, _, s, proj in block_plan(cfg):
        y = F.relu(_bn(params, f"{prefix}_1x1_reduce_bn",
                       _conv(params, f"{prefix}_1x1_reduce", x, s), eps))
        y = F.relu(_bn(params, f"{prefix}_3x3_bn",
                       _conv(params, f"{prefix}_3x3", y, padding=1), eps))
        y = _bn(params, f"{prefix}_1x1_increase_bn",
                _conv(params, f"{prefix}_1x1_increase", y), eps)
        z = gate_logits(params, prefix, y)
        if at_gate is not None:
            z = at_gate(prefix, z)
        g = torch.sigmoid(z)
        if flat_gates:
            g = g.mean(dim=1, keepdim=True)
        y = y * g[:, :, None, None]
        if proj:
            r = _bn(params, f"{prefix}_1x1_proj_bn",
                    _conv(params, f"{prefix}_1x1_proj", x, s), eps)
        else:
            r = x
        x = F.relu(y + r)
    x = F.avg_pool2d(x, 7, 1)
    return _conv(params, "feat_extract", x).flatten(1)


def encode(params, cfg, x, flat_gates=False):
    """[N,3,224,224] -> [N,256] embeddings (``feat_extract``'s output)."""
    return network(params, cfg, x, flat_gates)


def preprocess(images_hwc):
    """[N,H,W,3] float RGB 0..255 -> [N,3,H,W] less ``MEAN_BGRISH``,
    contiguous."""
    mean = torch.tensor(MEAN_BGRISH, dtype=images_hwc.dtype,
                        device=images_hwc.device)
    return (images_hwc - mean).permute(0, 3, 1, 2).contiguous()


@torch.no_grad()
def calibrate_gates(params, cfg, images_hwc, target):
    """Scale each block's ``*_1x1_up`` weight and bias in place, block by
    block in call order, so that its gate logits at the uint8 images
    [N,H,W,3] have a standard deviation across channels of ``target``
    (the mean over the images); float32 with TF32 off.  Returns
    {prefix: the scale}."""
    scales = {}

    def at_gate(prefix, z):
        s = target / float(z.std(dim=1).mean())
        up = params[f"{prefix}_1x1_up"]
        up["w"].mul_(s)
        up["b"].mul_(s)
        scales[prefix] = s
        return z * s

    with precision(False):
        network(params, cfg, preprocess(images_hwc.float()),
                at_gate=at_gate)
    return scales


def calibrate(params, cfg, images_hwc):
    """The configuration's calibration of its weights (``harness.weights``):
    the gates at the uint8 images [N,H,W,3] to ``se_logit_std``."""
    calibrate_gates(params, cfg, images_hwc, cfg["se_logit_std"])


@torch.no_grad()
def gate_spread(params, cfg, images_hwc):
    """{prefix: (the logits' std across channels, the gates' 5th and 95th
    percentiles)} at the uint8 images [N,H,W,3], float32 with TF32 off:
    how far the gates spread over (0, 1)."""
    out = {}

    def at_gate(prefix, z):
        g = torch.sigmoid(z).flatten()
        q = torch.quantile(g.double(), torch.tensor(
            [0.05, 0.95], dtype=torch.float64, device=g.device))
        out[prefix] = (float(z.std(dim=1).mean()), float(q[0]),
                       float(q[1]))
        return z

    with precision(False):
        network(params, cfg, preprocess(images_hwc.float()),
                at_gate=at_gate)
    return out


def forward_macs(cfg, chw=(3, 224, 224), head=False):
    """Multiply-adds of one image's forward to the embedding through the
    convolutions (the excitations' 1x1s included), from the shapes alone;
    ``head`` adds the 2-class ``fc1``."""
    shapes = param_shapes(cfg)
    macs, h, w = 0, chw[1], chw[2]

    def conv(name, h, w, stride=1, padding=0):
        cout, cin, kh, kw = shapes[name]["w"]
        h = (h + 2 * padding - kh) // stride + 1
        w = (w + 2 * padding - kw) // stride + 1
        return cout * h * w * cin * kh * kw, h, w

    m, h, w = conv("conv1_7x7_s2", h, w, 2, 3)
    macs += m
    h, w = -(-(h - 3) // 2) + 1, -(-(w - 3) // 2) + 1  # ceil-mode pool
    for prefix, _, _, _, s, proj in block_plan(cfg):
        if proj:
            m, _, _ = conv(f"{prefix}_1x1_proj", h, w, s)
            macs += m
        m, h, w = conv(f"{prefix}_1x1_reduce", h, w, s)
        macs += m
        for name in ("_3x3", "_1x1_increase"):
            m, _, _ = conv(prefix + name, h, w,
                           padding=1 if name == "_3x3" else 0)
            macs += m
        for name in ("_1x1_down", "_1x1_up"):
            macs += conv(prefix + name, 1, 1)[0]
    h, w = h - 6, w - 6  # the 7x7 average pool, stride 1
    macs += conv("feat_extract", h, w)[0]
    if head:
        macs += cfg["num_classes"] * cfg["embed_dim"]
    return macs


def first_conv_macs(cfg, chw=(3, 224, 224)):
    """Multiply-adds of the stem's 7x7/2 convolution alone (pad 3, to 64
    channels)."""
    h, w = (chw[1] - 1) // 2 + 1, (chw[2] - 1) // 2 + 1
    return 64 * h * w * chw[0] * 49


def param_shapes(cfg):
    """{name: {key: shape}} of the network under the converted model's
    layer names, with xfr's 2-class ``fc1``."""
    shapes = {"conv1_7x7_s2": {"w": (64, 3, 7, 7)},
              "conv1_7x7_s2_bn": _bn_shapes(64)}
    r = cfg["se_reduction"]
    for prefix, cin, planes, cout, _, proj in block_plan(cfg):
        shapes[f"{prefix}_1x1_reduce"] = {"w": (planes, cin, 1, 1)}
        shapes[f"{prefix}_1x1_reduce_bn"] = _bn_shapes(planes)
        shapes[f"{prefix}_3x3"] = {"w": (planes, planes, 3, 3)}
        shapes[f"{prefix}_3x3_bn"] = _bn_shapes(planes)
        shapes[f"{prefix}_1x1_increase"] = {"w": (cout, planes, 1, 1)}
        shapes[f"{prefix}_1x1_increase_bn"] = _bn_shapes(cout)
        shapes[f"{prefix}_1x1_down"] = {"w": (cout // r, cout, 1, 1),
                                        "b": (cout // r,)}
        shapes[f"{prefix}_1x1_up"] = {"w": (cout, cout // r, 1, 1),
                                      "b": (cout,)}
        if proj:
            shapes[f"{prefix}_1x1_proj"] = {"w": (cout, cin, 1, 1)}
            shapes[f"{prefix}_1x1_proj_bn"] = _bn_shapes(cout)
    shapes["feat_extract"] = {"w": (cfg["embed_dim"], 2048, 1, 1)}
    shapes["fc1"] = {"w": (cfg["num_classes"], cfg["embed_dim"])}
    return shapes


def _bn_shapes(c):
    return {"gamma": (c,), "beta": (c,), "mean": (c,), "var": (c,)}
