"""Faster R-CNN face detection network as graph IR (port of
xfr_tpu/detection/network.py).

Three parts like the converted Caffe model: the trunk = ResNet-101 to res4
(stride 16), the rpn = a 3x3 conv + cls/bbox 1x1 heads over 9 anchors,
the top = the res5 stage + (cls_score[2], bbox_pred[8]) heads over 14x14
RoI-pooled features.  The trunk, rpn and top run on the device; the
proposal layer and RoI pooling run on the host in numpy, as in the JAX
package (300 small boxes).

Layer structure and parameter names are the JAX package's (the MMdnn
KitModel attribute names): Caffe branch naming (res2a_branch2a /
bn2a_branch2a / ...), a right/bottom-padded pool1 (a ceil-mode 3x3/2 pool
with no leading pad), dilation-2 res5 3x3 convs, BN eps 9.99999974738e-06,
heads cls_score_1/bbox_pred_1, rpn_conv_3x3.  A state_dict of the
reference's three detector modules converts mechanically — see
``load_from_torch_state_dicts``.

The detector runs its convolutions in full float32
(``precision_scope("high")``), with no option for another precision, as
the JAX package's detector has none: NMS and the confidence threshold are
discontinuous, so TF32's rounding could change which boxes survive.
"""

from __future__ import annotations

import numpy as np
import torch

from xfr_torch import ops as O
from xfr_torch.detection import boxes as B
from xfr_torch.ebp import interpreter as I
from xfr_torch.graph import GraphBuilder
from xfr_torch.models.common import init_params, params_to
from xfr_torch.utils.device import precision_scope, resolve_device

_BN_EPS = 9.99999974738e-06  # MMdnn defs (bottom_layers.py)
PARTS = ("trunk", "rpn", "top")
# float32 precision of the detector's convolutions (see the module
# docstring); chip_smoke.py swaps it to time TF32 beside it
_PRECISION = "high"


def _caffe_block_tags(stage, blocks):
    """Caffe block letters: res2{a,b,c}, res3{a,b1..}, res4{a,b1..b22},
    res5{a,b,c}."""
    if blocks <= 3:
        return ["abc"[b] for b in range(blocks)]
    return ["a"] + ["b%d" % i for i in range(1, blocks)]


def _res_stage(g, x, cin, planes, cout, blocks, stride, stage,
               dilation=1):
    for tag in _caffe_block_tags(stage, blocks):
        s = stride if tag == "a" else 1
        pad = dilation  # 3x3 conv keeps resolution: pad == dilation
        y = g.conv2d(x, cin, planes, 1, stride=s, bias=False,
                     name=f"res{stage}{tag}_branch2a")
        y = g.batchnorm2d(y, planes, eps=_BN_EPS,
                          name=f"bn{stage}{tag}_branch2a")
        y = g.relu(y, inplace=True)
        y = g.conv2d(y, planes, planes, 3, padding=pad, dilation=dilation,
                     bias=False, name=f"res{stage}{tag}_branch2b")
        y = g.batchnorm2d(y, planes, eps=_BN_EPS,
                          name=f"bn{stage}{tag}_branch2b")
        y = g.relu(y, inplace=True)
        y = g.conv2d(y, planes, cout, 1, bias=False,
                     name=f"res{stage}{tag}_branch2c")
        y = g.batchnorm2d(y, cout, eps=_BN_EPS,
                          name=f"bn{stage}{tag}_branch2c")
        if tag == "a":
            r = g.conv2d(x, cin, cout, 1, stride=s, bias=False,
                         name=f"res{stage}{tag}_branch1")
            r = g.batchnorm2d(r, cout, eps=_BN_EPS,
                              name=f"bn{stage}{tag}_branch1")
        else:
            r = x
        x = g.node("add", (y, r), hooked=False, tag="FuncAdd")
        x = g.relu(x, inplace=True)
        cin = cout
    return x, cin


def build_trunk():
    """conv1..res4 (1024 ch, stride 16)."""
    g = GraphBuilder("frcnn_trunk")
    x = g.conv2d(0, 3, 64, 7, stride=2, padding=3, bias=False, name="conv1")
    x = g.batchnorm2d(x, 64, eps=_BN_EPS, name="bn_conv1")
    x = g.relu(x, inplace=True)
    # pool1: right/bottom-only -inf pad + 3x3/2 pool == ceil_mode pooling
    # with no leading pad
    x = g.maxpool2d(x, 3, stride=2, padding=0, ceil_mode=True)
    x, cin = _res_stage(g, x, 64, 64, 256, 3, 1, 2)
    x, cin = _res_stage(g, x, cin, 128, 512, 4, 2, 3)
    x, cin = _res_stage(g, x, cin, 256, 1024, 23, 2, 4)
    return g.finalize(x), g.param_shapes


def build_rpn(num_anchors=9):
    """rpn_conv_3x3 + ReLU + the rpn_cls_score head (the graph's output).
    The bbox head is ``build_rpn_bbox``'s graph, as in the JAX package;
    the network applies its last node to this graph's ReLU output, so the
    shared 3x3 conv runs once."""
    g = GraphBuilder("frcnn_rpn")
    x = g.conv2d(0, 1024, 512, 3, padding=1, name="rpn_conv_3x3")
    x = g.relu(x, inplace=True)
    cls = g.conv2d(x, 512, 2 * num_anchors, 1, name="rpn_cls_score")
    return g.finalize(cls), g.param_shapes


def build_rpn_bbox(num_anchors=9):
    g = GraphBuilder("frcnn_rpn_bbox")
    x = g.conv2d(0, 1024, 512, 3, padding=1, name="rpn_conv_3x3")
    x = g.relu(x, inplace=True)
    bbox = g.conv2d(x, 512, 4 * num_anchors, 1, name="rpn_bbox_pred")
    return g.finalize(bbox), g.param_shapes


def build_top(num_classes=2):
    """res5 (dilation-2 3x3s, stride-2 entry) over 14x14 RoI features ->
    7x7 avgpool -> cls/bbox heads."""
    g = GraphBuilder("frcnn_top")
    x, cin = _res_stage(g, 0, 1024, 512, 2048, 3, 2, 5, dilation=2)
    x = g.avgpool2d(x, 7, stride=1)
    x = g.flatten(x)
    cls = g.linear(x, 2048, num_classes, name="cls_score_1")
    bbox = g.linear(x, 2048, 4 * num_classes, name="bbox_pred_1")
    # two heads: expose bbox as output, read cls from its tensor id
    g_out = g.finalize(bbox)
    return g_out, g.param_shapes, cls


def _part_shapes():
    _, trunk_shapes = build_trunk()
    _, rpn_shapes = build_rpn()
    _, rpn_bbox_shapes = build_rpn_bbox()
    _, top_shapes, _ = build_top()
    return {"trunk": trunk_shapes, "rpn": {**rpn_shapes, **rpn_bbox_shapes},
            "top": top_shapes}


def load_from_torch_state_dicts(bottom_sd, rpn_sd, top_sd,
                                dtype=torch.float32, device="cuda"):
    """Convert state_dicts of the reference's three detector modules
    (their keys are the parameter names of these builders):

        net = FasterRCNNNetwork(params=load_from_torch_state_dicts(
            torch.load(d + '/bottom.pkl').state_dict(),
            torch.load(d + '/rpn.pkl').state_dict(),
            torch.load(d + '/top.pkl').state_dict()))
    """
    from xfr_torch.models.convert import params_from_state_dict

    shapes = _part_shapes()
    return {part: params_from_state_dict(shapes[part], sd, dtype=dtype,
                                         device=device)
            for part, sd in zip(PARTS, (bottom_sd, rpn_sd, top_sd))}


def params_from_jax(np_params, device="cuda", dtype=None):
    """The JAX detector's ``{"trunk", "rpn", "top"}`` params (numpy, or
    anything ``np.asarray`` takes) -> the port's, on ``device``."""
    from xfr_torch.models import convert

    return {part: convert.params_from_jax(p, device=device, dtype=dtype)
            for part, p in np_params.items()}


@torch.no_grad()
def _forward(graph, params, x, keep):
    """``keep``'s tensors of a forward op by op, without autograd: the
    detector's forwards, at shapes that follow the image, run no fused
    epilogue."""
    return I.forward_values(graph, params, x, keep=keep)


class FasterRCNNNetwork:
    """__call__(im [1,3,H,W], im_info [[H, W, scale]]) ->
        (rois [R,5], bbox_pred [R,8], cls_prob [R,2], cls_score [R,2]),
    numpy arrays, as the JAX package's network returns them.

    ``params`` parts left out are drawn from the numpy ``init_params``
    with seeds ``seed``, ``seed+1`` and ``seed+2`` (the JAX package's
    values, bit for bit).  The image is cast to the trunk's parameter
    dtype; ``device`` defaults to the card and raises without one.
    """

    def __init__(self, params=None, seed=0, device="cuda"):
        self.device = resolve_device(device)
        self.trunk_graph, _ = build_trunk()
        self.rpn_graph, _ = build_rpn()
        self.rpn_bbox_graph, _ = build_rpn_bbox()
        self.top_graph, _, self._cls_tensor = build_top()
        shapes = _part_shapes()
        if params is None:
            params = {}
        for part in PARTS:
            # an explicitly-provided-but-empty part means a conversion
            # matched zero keys: refuse rather than silently running a
            # random-weight detector that returns garbage detections
            if part in params and not params[part]:
                raise ValueError("params[%r] is empty — the checkpoint "
                                 "conversion produced no %s weights"
                                 % (part, part))
        self.params = {
            part: params_to(params.get(part) or
                            init_params(shapes[part], seed=seed + i),
                            self.device)
            for i, part in enumerate(PARTS)}
        self.dtype = self.params["trunk"]["conv1"]["w"].dtype
        self._num_anchors = B.ANCHORS.shape[0]
        self._feat_stride = B.FEAT_STRIDE
        # the RPN's bbox head reads the rpn graph's ReLU output
        self._rpn_relu = self.rpn_graph.nodes[-1].ins[0]
        self._rpn_bbox_node = self.rpn_bbox_graph.nodes[-1]

    def _features_and_rpn(self, im):
        """Trunk and RPN on the device: (feats [1,1024,h,w], RPN
        probabilities [1,2A,h,w] with the softmax over the reshaped
        scores, bbox deltas [1,4A,h,w])."""
        tg, rg, node = self.trunk_graph, self.rpn_graph, self._rpn_bbox_node
        with precision_scope(_PRECISION):
            feats = _forward(tg, self.params["trunk"], im,
                             keep=(tg.output_id,))[tg.output_id]
            vals = _forward(rg, self.params["rpn"], feats,
                            keep=(self._rpn_relu, rg.output_id))
            cls = vals[rg.output_id]
            bbox = O.apply_op(node.op, self.params["rpn"][node.pname],
                              (vals[self._rpn_relu],), node.attrs_dict)
        n, c, h, w = cls.shape
        prob = torch.softmax(cls.reshape(n, 2, -1, w), dim=1)
        prob = prob.reshape(n, 2 * self._num_anchors, -1, w)
        return feats, prob, bbox

    def _top(self, roi_feats):
        """res5 and the heads on the device: (bbox_pred, cls_prob,
        cls_score)."""
        tg, cls_t = self.top_graph, self._cls_tensor
        with precision_scope(_PRECISION):
            values = _forward(tg, self.params["top"], roi_feats,
                              keep=(tg.output_id, cls_t))
        cls_score = values[cls_t]
        return values[tg.output_id], torch.softmax(cls_score, dim=1), \
            cls_score

    def _to_device(self, arr):
        return torch.as_tensor(np.asarray(arr), dtype=self.dtype,
                               device=self.device)

    def __call__(self, im, im_info):
        feats, prob, bbox = self._features_and_rpn(self._to_device(im))
        rois = B.proposal_layer(prob.cpu().numpy(), bbox.cpu().numpy(),
                                im_info, num_anchors=self._num_anchors,
                                feat_stride=self._feat_stride)
        if rois.shape[0] == 0:
            # degenerate case (e.g. every proposal under min_size): an
            # empty detection set instead of a zero-batch top stage
            return (rois, np.zeros((0, 8), np.float32),
                    np.zeros((0, 2), np.float32),
                    np.zeros((0, 2), np.float32))
        roi_feats = B.roi_pool(feats.cpu().numpy(), rois, (14, 14), 0.0625)
        bbox_pred, cls_prob, cls_score = self._top(
            self._to_device(roi_feats))
        return (rois, bbox_pred.cpu().numpy(), cls_prob.cpu().numpy(),
                cls_score.cpu().numpy())

    @staticmethod
    def _nms(dets, thresh):
        return B.nms(dets, thresh)
