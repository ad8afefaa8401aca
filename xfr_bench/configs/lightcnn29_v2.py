"""The measured program's LightCNN-29 v2 matcher, built from the
configuration's sizes around the benchmark's weights, as the program's
factory builds ``lightcnn``."""

from __future__ import annotations

import functools

from xfr_bench.harness import same_template


def program(cfg, params, device):
    """The program's ``Whitebox`` over ``params`` on ``device``."""
    from xfr_torch.ebp.engine import Whitebox, WhiteboxNetwork
    from xfr_torch.models import lightcnn as LCNN

    graph, shapes, enc = LCNN.build_lightcnn29v2(
        num_classes=cfg["num_classes"], layers=tuple(cfg["layers"]))
    same_template(shapes, params)
    net = WhiteboxNetwork(
        graph, params, encode_tensor=enc, classifier_pname="fc2",
        num_classes=cfg["num_classes"],
        preprocess=functools.partial(LCNN.preprocess_lightcnn,
                                     device=device),
        embed_dim=cfg["embed_dim"], name=cfg["program_name"])
    wb = Whitebox(net, ebp_subtree_mode=cfg["ebp_subtree_mode"])
    wb.match_threshold = cfg["match_threshold"]
    wb.platts_scaling = cfg["platts_scaling"]
    return wb
