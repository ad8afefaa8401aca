"""Plain PyTorch reference of the STR-Janus ResNet-101+L2 matcher.

Written from the published network (stresearch/xfr
``python/xfr/models/resnet.py``): a 7x7/2 stem with BatchNorm, ReLU and a
3x3/2 max pool, four bottleneck stages of [3, 4, 23, 3] blocks whose
first 1x1 convolution carries the stride, a parameter-free shortcut
(average pool by the stride, then zero channels appended), a 7x7 average
pool, fc1 to 512, L2 normalization times 50 (the embedding) and fc2 over
the classes.  Every convolution has a bias.  It reads a ``{name: {key:
tensor}}`` parameter dict whose names are the published state_dict's
prefixes.

Besides the forward, ``mean_ebp_conv1`` is excitation backprop as the
published xfr computes it (two forward passes, then torch autograd with a
tensor hook on every hooked module input): the marginal winning
probability at the first convolution's output, under a uniform class
prior.  It imports nothing of the measured program.
"""

from __future__ import annotations

import torch

from xfr_bench.reference import ebp as E


def block_plan(cfg):
    """[(prefix, inplanes, planes, stride, downsample)] of every
    bottleneck, in call order."""
    plan, inplanes = [], 64
    for li, (planes, blocks, stride) in enumerate(
            zip((64, 128, 256, 512), cfg["layers"], (1, 2, 2, 2))):
        for bi in range(blocks):
            s = stride if bi == 0 else 1
            ds = bi == 0 and (s != 1 or inplanes != planes * 4)
            plan.append((f"layer{li + 1}.{bi}", inplanes, planes, s, ds))
            inplanes = planes * 4
    return plan


def network(ex, cfg, x, head=True):
    """The network over an executor ``ex`` (``ebp.Executor``): returns the
    embedding's handle, and the class scores' with ``head``."""
    x = ex.conv("conv1", x, stride=2, padding=3)
    x = ex.bn("bn1", x, cfg["bn_eps"])
    x = ex.relu(x)
    x = ex.maxpool(x, 3, 2, 1)
    for prefix, inplanes, planes, s, ds in block_plan(cfg):
        y = ex.conv(f"{prefix}.conv1", x, stride=s)
        y = ex.bn(f"{prefix}.bn1", y, cfg["bn_eps"])
        y = ex.relu(y)
        y = ex.conv(f"{prefix}.conv2", y, padding=1)
        y = ex.bn(f"{prefix}.bn2", y, cfg["bn_eps"])
        y = ex.relu(y)
        y = ex.conv(f"{prefix}.conv3", y)
        y = ex.bn(f"{prefix}.bn3", y, cfg["bn_eps"])
        if ds:
            r = ex.avgpool(x, s)
            r = ex.concat_zeros(r, planes * 4 // inplanes - 1)
        else:
            r = x
        x = ex.relu(ex.add(y, r))
    x = ex.avgpool(x, 7)
    x = ex.flatten(x)
    x = ex.linear("fc1", x)
    x = ex.l2normalize(x)
    enc = ex.scale(x, cfg["embed_scale"])
    if not head:
        return enc, None
    return enc, ex.linear("fc2", enc)


def preprocess(images_hwc):
    """[N,H,W,3] float RGB 0..255 -> [N,3,H,W] less the published mean
    RGB, contiguous."""
    mean = torch.tensor(MEAN_RGB, dtype=images_hwc.dtype,
                        device=images_hwc.device)
    return (images_hwc - mean).permute(0, 3, 1, 2).contiguous()


MEAN_RGB = (122.782, 117.001, 104.298)


def encode(params, cfg, x):
    """[N,3,224,224] -> [N,512] embeddings (the Multiply(50) output)."""
    ex = E.Forward(params)
    enc, _ = network(ex, cfg, ex.input(x), head=False)
    return ex.value(enc)


def mean_ebp_conv1(params, cfg, x, eps=1e-16):
    """Excitation backprop (the ``norelu`` subtree mode, no bias swap)
    from a uniform prior over the classes: the MWP at the first
    convolution's output, [1, 64, 112, 112], for one image x [1,3,H,W]."""
    ncls = params["fc2"]["w"].shape[0]
    prior = torch.full((1, ncls), 1.0 / ncls, dtype=x.dtype,
                       device=x.device)
    return E.mwp_at(lambda ex, t: network(ex, cfg, t)[1], params, x, prior,
                    watch=("bn1", 0), eps=eps)


def forward_macs(cfg, chw=(3, 224, 224), head=False):
    """Multiply-adds of one image's forward through the convolutions and
    linear layers, from the shapes alone (``ebp.Counter``)."""
    ex = E.Counter(param_shapes(cfg))
    network(ex, cfg, ex.input(chw), head=head)
    return ex.macs


def first_conv_macs(cfg, chw=(3, 224, 224)):
    """Multiply-adds of the first convolution alone (7x7, stride 2, pad
    3, to 64 channels)."""
    h, w = (chw[1] - 1) // 2 + 1, (chw[2] - 1) // 2 + 1
    return 64 * h * w * chw[0] * 49


def param_shapes(cfg):
    """{name: {key: shape}} of the network, as the published state_dict
    holds it."""
    shapes = {"conv1": {"w": (64, 3, 7, 7), "b": (64,)},
              "bn1": _bn(64)}
    for prefix, inplanes, planes, s, ds in block_plan(cfg):
        shapes[f"{prefix}.conv1"] = {"w": (planes, inplanes, 1, 1),
                                     "b": (planes,)}
        shapes[f"{prefix}.bn1"] = _bn(planes)
        shapes[f"{prefix}.conv2"] = {"w": (planes, planes, 3, 3),
                                     "b": (planes,)}
        shapes[f"{prefix}.bn2"] = _bn(planes)
        shapes[f"{prefix}.conv3"] = {"w": (planes * 4, planes, 1, 1),
                                     "b": (planes * 4,)}
        shapes[f"{prefix}.bn3"] = _bn(planes * 4)
    shapes["fc1"] = {"w": (cfg["embed_dim"], 2048), "b": (cfg["embed_dim"],)}
    shapes["fc2"] = {"w": (cfg["num_classes"], cfg["embed_dim"]),
                     "b": (cfg["num_classes"],)}
    return shapes


def _bn(c):
    return {"gamma": (c,), "beta": (c,), "mean": (c,), "var": (c,)}

