"""The measured program's VGGFace2 SENet-50-256 matcher, built from the
configuration's sizes around the benchmark's weights, as the program's
factory builds ``senet50_256``."""

from __future__ import annotations

import functools

from xfr_bench.harness import same_template


def program(cfg, params, device):
    """The program's ``Whitebox`` over ``params`` on ``device``; raises if
    the program's parameter template differs from the reference's."""
    from xfr_torch.ebp.engine import Whitebox, WhiteboxNetwork
    from xfr_torch.models import vggface2 as VF2

    graph, shapes, enc = VF2.build_senet50_256(
        num_classes=cfg["num_classes"], layers=tuple(cfg["layers"]))
    same_template(shapes, params)
    net = WhiteboxNetwork(
        graph, params, encode_tensor=enc, classifier_pname="fc1",
        num_classes=cfg["num_classes"],
        preprocess=functools.partial(VF2.preprocess_vggface2,
                                     device=device),
        embed_dim=cfg["embed_dim"], name=cfg["program_name"])
    return Whitebox(net, ebp_subtree_mode="norelu")
