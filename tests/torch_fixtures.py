"""Shared helpers of the xfr_torch parity tests: the port's twin of
tests/fixtures.make_toy_wbnet, built with the port's GraphBuilder and
carrying the JAX net's parameters across."""

import numpy as np
import torch

from xfr_torch.ebp.engine import Whitebox, WhiteboxNetwork
from xfr_torch.graph import GraphBuilder
from xfr_torch.models.convert import params_from_jax

# six xdist workers share the host's cores
torch.set_num_threads(2)


def jax_params_np(params, dtype=None):
    """JAX params pytree -> {pname: {key: numpy array}}."""
    return {k: {kk: np.asarray(vv, dtype) for kk, vv in v.items()}
            for k, v in params.items()}


def toy_graph():
    """The graph of tests/fixtures.make_toy_wbnet, built by the port."""
    g = GraphBuilder("toynet")
    x = g.conv2d(0, 3, 8, 7, stride=4, padding=3, name="conv1")
    x = g.batchnorm2d(x, 8, name="bn1")
    x = g.relu(x, inplace=True)
    x = g.maxpool2d(x, 2)
    x = g.conv2d(x, 8, 16, 3, stride=2, padding=1, name="conv2")
    x = g.relu(x, inplace=True)
    x = g.avgpool2d(x, 14)
    x = g.flatten(x)
    x = g.linear(x, 16, 12, name="fc1")
    x = g.l2normalize(x)
    enc = g.multiply_const(x, 50.0)
    out = g.linear(enc, 12, 5, bias=False, name="fc2")
    return g, enc, out


def torch_twin(jax_wb, dtype=None, with_bias=None):
    """The port's Whitebox over the same toy graph and the JAX net's
    parameters, on the CPU."""
    g, enc, out = toy_graph()
    graph = g.finalize(out)
    num_classes = jax_wb.net.num_classes()
    # fc2's shape (num_classes) lives in the params, not in the graph
    params = params_from_jax(jax_params_np(jax_wb.net.params, dtype),
                             device="cpu")
    net = WhiteboxNetwork(graph, params, encode_tensor=enc,
                          classifier_pname="fc2", num_classes=num_classes,
                          embed_dim=12, name="toynet")
    wb = Whitebox(net, ebp_version=6,
                  ebp_subtree_mode=jax_wb.ebp_subtree_mode(),
                  eps=jax_wb.eps, with_bias=with_bias)
    wb.match_threshold = jax_wb.match_threshold
    wb.platts_scaling = jax_wb.platts_scaling
    return wb
