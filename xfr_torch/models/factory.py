"""Network factory: name -> configured Whitebox engine (port of
xfr_tpu/models/factory.py, ResNet-101 branch only).

Builds the graph, loads weights, wraps in WhiteboxNetwork/Whitebox with
the per-net default subtree mode and the published match-threshold /
Platt-scaling calibration constants.

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
from xfr_torch.models import resnet101 as R101
from xfr_torch.utils.device import resolve_device

WEIGHT_FILES = {
    "resnetv6_pytorch": "models/resnet101_l2_d512_twocrop.pth",
    "resnetv4_pytorch": "models/resnet101v4_28NOV17_train.pth",
}

# Nets of the JAX factory that the port has not reached yet, with the
# ROADMAP item that brings them.
_NOT_PORTED = {
    "vggface2_resnet50": "queue 1, item 7 (models/vggface2.py)",
    "senet50_256": "queue 1, item 7 (models/vggface2.py)",
    "lightcnn": "queue 1, item 7 (models/lightcnn.py)",
}


def _load_or_init(net_name, param_shapes, weights_path, device):
    path = weights_path or os.path.join(xfr_root, WEIGHT_FILES[net_name])
    if os.path.exists(path):
        sd = convert.load_torch_checkpoint(path, key=None)
        return convert.params_from_state_dict(param_shapes, sd,
                                              device=device)
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
    if net_name in _NOT_PORTED:
        raise NotImplementedError(
            f'network "{net_name}" is not ported yet: ROADMAP '
            f"{_NOT_PORTED[net_name]}")
    if net_name not in ("resnetv6_pytorch", "resnetv4_pytorch"):
        raise NotImplementedError(
            'create_wbnet does not implement network "%s"' % net_name)

    dev = resolve_device(device)
    if ebp_subtree_mode is None:
        ebp_subtree_mode = "norelu"
    graph, shapes, enc = R101.build_resnet101()
    params = _load_or_init(net_name, shapes, weights_path, dev)
    net = WhiteboxNetwork(
        graph, params, encode_tensor=enc, classifier_pname="fc2",
        num_classes=65359,
        preprocess=functools.partial(R101.preprocess_resnet101, device=dev),
        embed_dim=512, name=net_name)
    wb = Whitebox(net, ebp_version=ebp_version,
                  ebp_subtree_mode=ebp_subtree_mode)
    if net_name == "resnetv6_pytorch":
        wb.match_threshold = R101.RESNETV6_MATCH_THRESHOLD
        wb.platts_scaling = R101.RESNETV6_PLATTS_SCALING
    else:
        wb.match_threshold = R101.RESNETV4_MATCH_THRESHOLD
        wb.platts_scaling = R101.RESNETV4_PLATTS_SCALING
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
