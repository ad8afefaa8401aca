"""Plain PyTorch reference of LightCNN-29 v2 (AlfredXiangWu/LightCNN
``light_cnn.py``, ``LightCNN_29Layers_v2``; Wu et al., arXiv:1511.02683).

Max-feature-map blocks (a convolution to 2C channels, then the
elementwise max of its two halves), residual blocks of two 3x3 mfm
convolutions, ``group`` blocks (a 1x1 mfm, then a 3x3 mfm), pooling as a
2x2 max pool plus a 2x2 average pool, no BatchNorm, and ``fc`` from
8*8*128 to the 256-d embedding (taken before the dropout and ``fc2``).
Grayscale 128x128 input.  It reads a ``{name: {key: tensor}}`` parameter
dict named as the published state_dict (less its ``module.`` prefix,
with ``.filter`` for the convolution inside an mfm block) and imports
nothing of the measured program.
"""

from __future__ import annotations

from xfr_bench.reference import ebp as E


def plan(cfg):
    """[(kind, name, cin, cout, kernel, padding)] in call order, where
    kind is "mfm", "res" (a residual block of channel c), or "pool"."""
    out = [("mfm", "conv1", 1, 48, 5, 2), ("pool",)]
    chans = ((48, 96), (96, 192), (192, 128), (128, 128))
    for gi, (blocks, (cin, cout)) in enumerate(zip(cfg["layers"], chans)):
        out += [("res", f"block{gi + 1}.{i}", cin) for i in range(blocks)]
        out += [("mfm", f"group{gi + 1}.conv_a", cin, cin, 1, 0),
                ("mfm", f"group{gi + 1}.conv", cin, cout, 3, 1)]
        if gi != 2:
            out.append(("pool",))
    return out


def network(ex, cfg, x):
    """The embedding's handle over an executor (``ebp.Forward`` or
    ``ebp.Counter``)."""
    def mfm(name, x, k, p):
        y = ex.conv(f"{name}.filter", x, 1, p)
        return ex.pair_max(ex.split(y))

    for step in plan(cfg):
        if step[0] == "pool":
            x = ex.funcadd(ex.maxpool(x, 2, 2), ex.avgpool(x, 2))
        elif step[0] == "res":
            y = mfm(f"{step[1]}.conv1", x, 3, 1)
            y = mfm(f"{step[1]}.conv2", y, 3, 1)
            x = ex.add(y, x)
        else:
            x = mfm(step[1], x, step[4], step[5])
    x = ex.flatten(x)
    return ex.linear("fc", x)


def encode(params, cfg, x):
    """[N,1,128,128] -> [N,256] embeddings."""
    ex = E.Forward(params)
    return ex.value(network(ex, cfg, ex.input(x)))


def forward_macs(cfg, chw=(1, 128, 128)):
    """Multiply-adds of one image's forward to the embedding, from the
    shapes alone."""
    ex = E.Counter(param_shapes(cfg))
    network(ex, cfg, ex.input(chw))
    return ex.macs


def param_shapes(cfg):
    """{name: {key: shape}} of the network, as the published state_dict
    holds it."""
    shapes = {}
    for step in plan(cfg):
        if step[0] == "res":
            c = step[2]
            for k in ("conv1", "conv2"):
                shapes[f"{step[1]}.{k}.filter"] = {"w": (2 * c, c, 3, 3),
                                                   "b": (2 * c,)}
        elif step[0] == "mfm":
            _, name, cin, cout, k, _ = step
            shapes[f"{name}.filter"] = {"w": (2 * cout, cin, k, k),
                                        "b": (2 * cout,)}
    shapes["fc"] = {"w": (cfg["embed_dim"], 8 * 8 * 128),
                    "b": (cfg["embed_dim"],)}
    shapes["fc2"] = {"w": (cfg["num_classes"], cfg["embed_dim"])}
    return shapes
