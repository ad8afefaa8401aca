"""Network factory: name -> configured Whitebox engine (port of
xfr_tpu/models/factory.py).

Builds the graph, loads weights, wraps in WhiteboxNetwork/Whitebox with
the per-net default subtree mode and the published match-threshold /
Platt-scaling calibration constants.  Nets: STR-Janus ResNet-101
("resnetv4_pytorch", "resnetv6_pytorch"), VGGFace2 ResNet-50-128
("vggface2_resnet50"), VGGFace2 SENet-50-256 ("senet50_256", encode
only: its EBP raises on the Sigmoid) and LightCNN-29 v2 ("lightcnn").

The original torch checkpoints are not vendored; when a checkpoint path
is missing the factory falls back to deterministic random weights seeded
by net name.  The JAX package draws those on device with the JAX PRNG,
which torch cannot reproduce, so the port uses the numpy
``common.init_params`` instead: the same distributions, other values.
"""

from __future__ import annotations

import functools
import os
import warnings
import zlib

from xfr_torch import xfr_root
from xfr_torch.ebp.engine import Whitebox, WhiteboxNetwork
from xfr_torch.models import common, convert
from xfr_torch.models import lightcnn as LCNN
from xfr_torch.models import resnet101 as R101
from xfr_torch.models import vggface2 as VF2
from xfr_torch.utils.device import resolve_device

WEIGHT_FILES = {
    "resnetv6_pytorch": "models/resnet101_l2_d512_twocrop.pth",
    "resnetv4_pytorch": "models/resnet101v4_28NOV17_train.pth",
    "vggface2_resnet50": "models/resnet50_128_pytorch/resnet50_128.pth",
    "senet50_256": "models/senet50_256_pytorch/senet50_256.pth",
    "lightcnn": "models/LightCNN_29Layers_V2_checkpoint.pth.tar",
}


def _load_or_init(net_name, param_shapes, weights_path, device,
                  strip_prefix=None, ckpt_key="state_dict", runtime_init=()):
    path = weights_path or os.path.join(xfr_root, WEIGHT_FILES[net_name])
    if os.path.exists(path):
        sd = convert.load_torch_checkpoint(path, strip_prefix=strip_prefix,
                                           key=ckpt_key)
        return convert.params_from_state_dict(
            param_shapes, sd, runtime_init=runtime_init, device=device)
    warnings.warn(
        f"weights for {net_name} not found at {path!r}; using deterministic "
        "random initialization (embeddings will not be face-meaningful)")
    # stable per-net seed: Python's str hash is salted per process
    seed = zlib.crc32(net_name.encode()) % 2**31
    return common.params_to(common.init_params(param_shapes, seed=seed),
                            device)


def create_wbnet(net_name, device="cuda", ebp_version=None,
                 ebp_subtree_mode=None, weights_path=None):
    """Build a configured Whitebox for a named matcher, its parameters on
    ``device`` (default "cuda"; raises without a card unless "cpu")."""
    if ebp_version is not None and ebp_version < 4:
        raise DeprecationWarning("EBP version must be >= 4")
    if net_name not in WEIGHT_FILES:
        raise NotImplementedError(
            'create_wbnet does not implement network "%s"' % net_name)
    dev = resolve_device(device)

    if net_name in ("resnetv6_pytorch", "resnetv4_pytorch"):
        graph, shapes, enc = R101.build_resnet101()
        params = _load_or_init(net_name, shapes, weights_path, dev,
                               ckpt_key=None)
        net = WhiteboxNetwork(
            graph, params, encode_tensor=enc, classifier_pname="fc2",
            num_classes=65359,
            preprocess=functools.partial(R101.preprocess_resnet101,
                                         device=dev),
            embed_dim=512, name=net_name)
        wb = Whitebox(net, ebp_version=ebp_version,
                      ebp_subtree_mode=ebp_subtree_mode or "norelu")
        if net_name == "resnetv6_pytorch":
            wb.match_threshold = R101.RESNETV6_MATCH_THRESHOLD
            wb.platts_scaling = R101.RESNETV6_PLATTS_SCALING
        else:
            wb.match_threshold = R101.RESNETV4_MATCH_THRESHOLD
            wb.platts_scaling = R101.RESNETV4_PLATTS_SCALING
        return wb

    if net_name in ("vggface2_resnet50", "senet50_256"):
        senet = net_name == "senet50_256"
        if ebp_version is not None and not senet:
            warnings.warn("ebp_version %s is ignored for %s"
                          % (ebp_version, net_name))
        build = VF2.build_senet50_256 if senet else VF2.build_resnet50_128
        graph, shapes, enc = build()
        # the real checkpoints carry no fc1: the triplet classifier is
        # built at runtime
        params = _load_or_init(net_name, shapes, weights_path, dev,
                               ckpt_key=None, runtime_init=("fc1",))
        net = WhiteboxNetwork(
            graph, params, encode_tensor=enc, classifier_pname="fc1",
            num_classes=2,
            preprocess=functools.partial(VF2.preprocess_vggface2,
                                         device=dev),
            embed_dim=256 if senet else 128, name=net_name)
        wb = Whitebox(net, ebp_version=ebp_version,
                      ebp_subtree_mode=ebp_subtree_mode or "norelu")
        if not senet:
            # SENet serves encode and embeddings only (its EBP raises on
            # the Sigmoid) and carries no calibration
            wb.match_threshold = VF2.VGGFACE2_MATCH_THRESHOLD
            wb.platts_scaling = VF2.VGGFACE2_PLATTS_SCALING
        return wb

    # lightcnn
    graph, shapes, enc = LCNN.build_lightcnn29v2(num_classes=80013)
    params = _load_or_init(net_name, shapes, weights_path, dev,
                           strip_prefix="module.")
    net = WhiteboxNetwork(
        graph, params, encode_tensor=enc, classifier_pname="fc2",
        num_classes=80013,
        preprocess=functools.partial(LCNN.preprocess_lightcnn, device=dev),
        embed_dim=256, name=net_name)
    wb = Whitebox(net, ebp_version=ebp_version,
                  ebp_subtree_mode=ebp_subtree_mode or
                  "affineonly_with_prior")
    wb.match_threshold = LCNN.LIGHTCNN_MATCH_THRESHOLD
    wb.platts_scaling = LCNN.LIGHTCNN_PLATTS_SCALING
    return wb


def create_net(net_name, ebp_version=6, device="cuda", net_dict=None):
    """Cached net factory: the same Whitebox per (name, ebp_version) when a
    ``net_dict`` cache is passed."""
    key = (net_name, ebp_version)
    if net_dict is not None and key in net_dict:
        return net_dict[key]
    wb = create_wbnet(net_name, device=device, ebp_version=ebp_version)
    if net_dict is not None:
        net_dict[key] = wb
    return wb
