"""Static SSA graph IR for face-embedding networks (port of
xfr_tpu/graph.py).

Each network is a list of ``Node``s in forward *call* order (one node per
torch module call, plus unhooked nodes for functional ops such as
F.normalize and view) over SSA tensor ids.  ``hooked`` marks nodes that
correspond to hooked leaf-module calls of the reference's EBP machinery.

From the IR we derive a static *event schedule* that reproduces the order
in which the reference's tensor backward hooks fire under torch autograd:

  * autograd processes grad nodes in descending creation (call) order;
  * a tensor's hooks fire right before its *producer*'s backward runs,
    i.e. when processing the producer node in that descending sweep;
  * multiple hooks on one tensor (fork points, e.g. the residual input of a
    Bottleneck consumed by both conv1 and Add) chain in registration order
    = ascending consumer call order, each receiving the previous hook's
    output.

The schedule is copied exactly from the JAX package: "layer k" of the
layerwise / weighted-subtree methods maps to ``events[k]`` in both.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

from xfr_torch import ops as O

# Substring-based rule dispatch mirroring the reference's str(module) checks.
AFFINE_SUBSTRINGS = ("Conv", "Linear", "AvgPool", "BatchNorm")
SPECIAL_SUBSTRINGS = ("Sigmoid", "ELU", "Tanh")
POOLRELU_SUBSTRINGS = ("MaxPool", "ReLU")

# Default torch-style type tag per op (used for rule dispatch and for
# P_layername parity).
DEFAULT_TAGS = {
    "conv2d": "Conv2d",
    "linear": "Linear",
    "batchnorm2d": "BatchNorm2d",
    "relu": "ReLU",
    "maxpool2d": "MaxPool2d",
    "avgpool2d": "AvgPool2d",
    "global_avgpool2d": "AdaptiveAvgPool2d",
    "add": "Add",
    "mul": "Mul",
    "multiply_const": "Multiply",
    "concat_zero_channels": "ConcatChannels",
    "split_identity": "Split",
    "pair_max": "PairMax",
    "flatten": "Flatten",
    "l2normalize": "Normalize",
    "dropout_eval": "Dropout",
    "sigmoid": "Sigmoid",
    "identity": "Identity",
}


@dataclasses.dataclass(frozen=True)
class Node:
    op: str                  # key into xfr_torch.ops.OPS
    ins: Tuple[int, ...]     # input tensor ids
    out: int                 # output tensor id
    tag: str                 # torch-style class tag, for EBP rule dispatch
    hooked: bool             # True iff this call had forward/pre-forward hooks
    pname: Optional[str]     # key into the params dict, or None
    attrs: Tuple[Tuple[str, Any], ...]  # static attributes (hashable)
    inplace: bool = False    # torch inplace op (e.g. nn.ReLU(inplace=True))

    @property
    def attrs_dict(self):
        return dict(self.attrs)


@dataclasses.dataclass(frozen=True)
class Event:
    """One tensor-backward-hook firing (one entry of the reference's
    self.P / self.dA lists).

    For torch *inplace* modules (nn.ReLU(inplace=True)) the module's own
    input hook is registered on the post-modification tensor version, so
    it fires on the gradient at the op *output*, before the op's backward,
    and ahead of later consumers' hooks in the chain.  ``tensor`` is where
    the hook fires; ``a_tensor``/``x_tensor`` are where the reference
    captured A (pass 1, post-forward) and X (pass 2, pre-forward).
    """
    idx: int          # position in fire order
    tensor: int       # tensor id the hook fires on
    consumer: int     # node index whose forward hook registered it
    slot: int         # which input slot of the consumer
    tag: str          # consumer's type tag (== reference P_layername entry)
    a_tensor: int = -1   # A = relu(values[a_tensor])
    x_tensor: int = -1   # X = relu(posvals[x_tensor])

    @property
    def is_affine(self):
        return any(s in self.tag for s in AFFINE_SUBSTRINGS)

    @property
    def is_special(self):
        return any(s in self.tag for s in SPECIAL_SUBSTRINGS)

    @property
    def is_poolrelu(self):
        return any(s in self.tag for s in POOLRELU_SUBSTRINGS)


class GraphDef:
    """Immutable network graph + derived EBP event schedule."""

    def __init__(self, nodes: Sequence[Node], n_tensors: int, input_id: int,
                 output_id: int, name: str = "graph"):
        self.nodes: Tuple[Node, ...] = tuple(nodes)
        self.n_tensors = n_tensors
        self.input_id = input_id
        self.output_id = output_id
        self.name = name

        # hooks[t] = [(consumer_node_idx, slot, a_tensor, x_tensor), ...]
        # ascending consumer idx (= torch hook registration order).
        hooks: Dict[int, List[Tuple[int, int, int, int]]] = {}
        consumers: Dict[int, List[int]] = {}
        for ni, node in enumerate(self.nodes):
            for slot, t in enumerate(node.ins):
                consumers.setdefault(t, []).append(ni)
                if node.hooked:
                    if node.inplace and slot == 0:
                        # inplace module: its input hook lives on the
                        # post-modification tensor (== node output); A was
                        # captured post-forward (rectified), X pre-forward
                        # (the natural positive-pass input).
                        hooks.setdefault(node.out, []).append(
                            (ni, slot, node.out, t))
                    else:
                        hooks.setdefault(t, []).append((ni, slot, t, t))
        # Keep registration (call) order within each tensor's hook chain.
        for t in hooks:
            hooks[t].sort(key=lambda h: h[0])
        self._hooks = hooks
        self._consumers = consumers
        # last_use[t]: index of the last node reading tensor t (forwards
        # that keep only some tensors free the others after it)
        self.last_use: Dict[int, int] = {t: max(c)
                                         for t, c in consumers.items()}
        # the squeeze-excite gates' broadcast multiplies (SENet's ``mul``
        # nodes, the only ones), applied once a row by a whole forward
        self.n_gates = sum(node.op == "mul" for node in self.nodes)

        # Static backward event schedule (see module docstring).
        events: List[Event] = []
        event_node: List[int] = []  # node index processed when event fires

        def _finalize(t: int, ni: int):
            for (ci, slot, at, xt) in hooks.get(t, ()):
                events.append(Event(
                    idx=len(events), tensor=t, consumer=ci, slot=slot,
                    tag=self.nodes[ci].tag, a_tensor=at, x_tensor=xt))
                event_node.append(ni)

        for ni in range(len(self.nodes) - 1, -1, -1):
            _finalize(self.nodes[ni].out, ni)
        _finalize(self.input_id, 0)
        self.events: Tuple[Event, ...] = tuple(events)
        # event_node[e]: starting the backward walk at node event_node[e]
        # (or any later node) suffices for event e to fire
        self.event_node: Tuple[int, ...] = tuple(event_node)

    def hooks_on(self, t: int):
        return self._hooks.get(t, ())

    @property
    def n_events(self):
        return len(self.events)

    def event_names(self):
        """Reference P_layername analogue."""
        return [e.tag for e in self.events]

    def __repr__(self):
        return (f"GraphDef({self.name}: {len(self.nodes)} nodes, "
                f"{self.n_tensors} tensors, {self.n_events} events)")


class GraphBuilder:
    """Builds a GraphDef + parameter-shape template in forward call order.

    Every method returns the output tensor id.  ``hooked`` marks calls that
    correspond to torch leaf modules visited by the reference's layer
    visitor; functional ops (normalize/flatten/max/F.dropout and the '+'
    of LightCNN-v2's pooling) are unhooked.
    """

    def __init__(self, name="graph"):
        self.name = name
        self.nodes: List[Node] = []
        self.n_tensors = 1  # tensor 0 is the network input
        self.input_id = 0
        self.param_shapes: Dict[str, Dict[str, Tuple[int, ...]]] = {}
        self._pname_counts: Dict[str, int] = {}

    # -- infrastructure ----------------------------------------------------

    def _new_tensor(self):
        t = self.n_tensors
        self.n_tensors += 1
        return t

    def _unique(self, base):
        n = self._pname_counts.get(base, 0)
        self._pname_counts[base] = n + 1
        return base if n == 0 else f"{base}_{n}"

    def node(self, op, ins, *, tag=None, hooked=True, pname=None,
             inplace=False, **attrs):
        out = self._new_tensor()
        self.nodes.append(Node(
            op=op,
            ins=tuple(ins),
            out=out,
            tag=tag or DEFAULT_TAGS[op],
            hooked=hooked,
            pname=pname,
            attrs=tuple(sorted(attrs.items())),
            inplace=inplace,
        ))
        return out

    def finalize(self, output_id):
        return GraphDef(self.nodes, self.n_tensors, self.input_id, output_id,
                        name=self.name)

    # -- layer helpers -----------------------------------------------------

    def conv2d(self, x, cin, cout, kernel, stride=1, padding=0, bias=True,
               dilation=1, name="conv"):
        pname = self._unique(name)
        kh, kw = (kernel, kernel) if isinstance(kernel, int) else kernel
        shapes = {"w": (cout, cin, kh, kw)}
        if bias:
            shapes["b"] = (cout,)
        self.param_shapes[pname] = shapes
        attrs = dict(stride=O._pair(stride), padding=O._pair(padding))
        if O._pair(dilation) != (1, 1):
            attrs["dilation"] = O._pair(dilation)
        return self.node("conv2d", (x,), pname=pname, **attrs)

    def linear(self, x, fin, fout, bias=True, name="fc"):
        pname = self._unique(name)
        shapes = {"w": (fout, fin)}
        if bias:
            shapes["b"] = (fout,)
        self.param_shapes[pname] = shapes
        return self.node("linear", (x,), pname=pname)

    def batchnorm2d(self, x, c, eps=1e-5, name="bn"):
        pname = self._unique(name)
        self.param_shapes[pname] = {
            "gamma": (c,), "beta": (c,), "mean": (c,), "var": (c,)}
        return self.node("batchnorm2d", (x,), pname=pname, eps=eps)

    def relu(self, x, inplace=False):
        return self.node("relu", (x,), inplace=inplace)

    def maxpool2d(self, x, kernel, stride=None, padding=0, ceil_mode=False):
        return self.node("maxpool2d", (x,), kernel=O._pair(kernel),
                         stride=O._pair(stride if stride is not None else kernel),
                         padding=O._pair(padding), ceil_mode=ceil_mode)

    def avgpool2d(self, x, kernel, stride=None, padding=0, ceil_mode=False):
        return self.node("avgpool2d", (x,), kernel=O._pair(kernel),
                         stride=O._pair(stride if stride is not None else kernel),
                         padding=O._pair(padding), ceil_mode=ceil_mode)

    def add(self, x, y):
        return self.node("add", (x, y))

    def multiply_const(self, x, c):
        return self.node("multiply_const", (x,), c=float(c))

    def concat_zero_channels(self, x, mult):
        return self.node("concat_zero_channels", (x,), mult=int(mult))

    def flatten(self, x):
        return self.node("flatten", (x,), hooked=False)

    def l2normalize(self, x, axis=1):
        return self.node("l2normalize", (x,), hooked=False, axis=axis)

    def dropout_eval(self, x):
        return self.node("dropout_eval", (x,), hooked=False)

    def funcadd(self, x, y):
        """Unhooked '+' (e.g. maxpool+avgpool in LightCNN-29v2)."""
        return self.node("add", (x, y), hooked=False, tag="FuncAdd")

    def mfm_conv(self, x, cin, cout, kernel, stride=1, padding=0, name="mfm"):
        """LightCNN max-feature-map conv block: Conv2d(2*cout) -> Split ->
        torch.max.  The Split module is a hooked identity at the conv
        output; the max is unhooked."""
        y = self.conv2d(x, cin, 2 * cout, kernel, stride, padding, bias=True,
                        name=name)
        y = self.node("split_identity", (y,))
        return self.node("pair_max", (y,), hooked=False)

    def mfm_linear(self, x, fin, fout, name="mfm_fc"):
        """LightCNN max-feature-map linear (type=0) block."""
        y = self.linear(x, fin, 2 * fout, bias=True, name=name)
        y = self.node("split_identity", (y,))
        return self.node("pair_max", (y,), hooked=False)
