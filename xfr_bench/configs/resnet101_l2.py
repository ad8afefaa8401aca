"""The measured program's STR-Janus ResNet-101+L2 matcher, built from the
configuration's sizes around the benchmark's weights, as the program's
factory builds ``resnetv6_pytorch``."""

from __future__ import annotations

import functools

from xfr_bench.harness import same_template


def program(cfg, params, device):
    """The program's ``Whitebox`` over ``params`` on ``device``; raises if
    the program's parameter template differs from the reference's."""
    from xfr_torch.ebp.engine import Whitebox, WhiteboxNetwork
    from xfr_torch.models import resnet101 as R101

    graph, shapes, enc = R101.build_resnet101(
        num_classes=cfg["num_classes"], layers=tuple(cfg["layers"]))
    same_template(shapes, params)
    net = WhiteboxNetwork(
        graph, params, encode_tensor=enc, classifier_pname="fc2",
        num_classes=cfg["num_classes"],
        preprocess=functools.partial(R101.preprocess_resnet101,
                                     device=device),
        embed_dim=cfg["embed_dim"], name=cfg["program_name"])
    wb = Whitebox(net, ebp_subtree_mode=cfg["ebp_subtree_mode"])
    wb.match_threshold = cfg["match_threshold"]
    wb.platts_scaling = cfg["platts_scaling"]
    return wb
