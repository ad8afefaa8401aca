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


def toy_preprocess(im):
    """tests/fixtures.toy_preprocess on the port: uint8/float HWC RGB ->
    [1,3,224,224] float32 in [0,1] on the CPU."""
    from xfr_torch.utils.image import resize

    arr = np.asarray(im, np.float64)
    if arr.max() > 1.5:
        arr = arr / 255.0
    if arr.shape[:2] != (224, 224):
        arr = resize(arr, (224, 224))
    return torch.from_numpy(
        np.ascontiguousarray(arr.transpose(2, 0, 1)[None], np.float32))


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
                          preprocess=toy_preprocess, embed_dim=12,
                          name="toynet")
    wb = Whitebox(net, ebp_version=6,
                  ebp_subtree_mode=jax_wb.ebp_subtree_mode(),
                  eps=jax_wb.eps, with_bias=with_bias)
    wb.match_threshold = jax_wb.match_threshold
    wb.platts_scaling = jax_wb.platts_scaling
    return wb


def twin_graph(jgraph):
    """The port's GraphDef over the nodes of a JAX package graph (the
    event schedule is the port's own, derived from the same nodes)."""
    import dataclasses

    from xfr_torch.graph import GraphDef, Node

    return GraphDef([Node(**dataclasses.asdict(n)) for n in jgraph.nodes],
                    jgraph.n_tensors, jgraph.input_id, jgraph.output_id,
                    name=jgraph.name)


def twin_whitebox(jax_wb, dtype=None, graph=None, ebp_version=None,
                  preprocess=None, **wb_kw):
    """The port's Whitebox over a JAX Whitebox's net (its graph's nodes,
    or ``graph``, and its parameters) on the CPU, with the JAX engine's
    subtree mode, eps, ebp version and calibration, and ``preprocess``."""
    jnet = jax_wb.net
    net = WhiteboxNetwork(
        graph or twin_graph(jnet.graph),
        params_from_jax(jax_params_np(jnet.params, dtype), device="cpu"),
        encode_tensor=jnet.encode_tensor,
        classifier_pname=jnet.classifier_pname,
        num_classes=jnet.num_classes(), preprocess=preprocess,
        embed_dim=jnet.embed_dim, name=jnet.name)
    wb = Whitebox(net, ebp_version=ebp_version or jax_wb.ebp_ver,
                  ebp_subtree_mode=jax_wb.ebp_subtree_mode(),
                  eps=jax_wb.eps, **wb_kw)
    wb.match_threshold = jax_wb.match_threshold
    wb.platts_scaling = jax_wb.platts_scaling
    return wb


class FakeNet:
    """A deterministic stand-in for the Faster R-CNN network
    (``FasterRCNN(net=FakeNet())`` in either package) whose detections
    depend on the image blob: RoIs, deltas and class probabilities drawn from a
    generator seeded by the blob's content.  Records each call's blob
    shape."""

    def __init__(self, n_rois=40):
        self.n_rois = n_rois
        self.calls = []

    def __call__(self, im_blob, im_info):
        im_blob = np.asarray(im_blob)
        self.calls.append(im_blob.shape)
        h, w = im_blob.shape[2:]
        seed = int(np.abs(im_blob.astype(np.float64)).sum() * 1000) % 2**31
        rng = np.random.RandomState(seed)
        xy = rng.rand(self.n_rois, 2) * [w * 0.6, h * 0.6]
        wh = rng.rand(self.n_rois, 2) * [w * 0.4, h * 0.4] + 8
        rois = np.hstack([np.zeros((self.n_rois, 1)), xy, xy + wh])
        bbox_pred = (rng.randn(self.n_rois, 8) * 0.1).astype(np.float32)
        score = rng.randn(self.n_rois, 2).astype(np.float32)
        prob = np.exp(score) / np.exp(score).sum(axis=1, keepdims=True)
        return rois.astype(np.float32), bbox_pred, prob, score
