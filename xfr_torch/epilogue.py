"""The fused elementwise epilogue of a keep-limited clean forward: a
convolution's bias, inference BatchNorm, a squeeze-excite gate, a residual
add and a ReLU in one pass over the activation.

``plan`` groups, once per (graph, kept tensors, biased convolutions, fuse),
each chain of single-reader pointwise nodes that follows a tensor, in the
order bias -> batchnorm2d -> mul by a [N, C, 1, 1] gate -> add of a
residual -> relu (each stage optional).  No tensor the chain fuses away is
kept or has a second reader.  A chain is kept when it holds a BatchNorm or
at least two stages.  ``interpreter.forward_clean`` runs such a plan for
every forward that keeps only some tensors (every encode); the EBP walks'
full forwards and autograd keep the op-by-op forward.

``fused_epilogue`` computes one chain.  On a CUDA float32 tensor it
launches the hand-written kernel ``csrc/fused_epilogue.cu``, which does the
eager ops in their order, each rounded as torch rounds it, so its output
equals the eager chain's bit for bit, with the strides the eager chain's
last op gives.  On a CPU tensor it runs ``fused_epilogue_reference``, the
eager ops themselves.  There is no fallback from one to the other; the
planner forms no chain for a CUDA tensor of another dtype.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional, Tuple

import torch

from xfr_torch import ops as O
from xfr_torch.utils.profiling import launched

# a stage's place in a chain; a chain's stages come in this order
_BIAS, _BN, _GATE, _ADD, _RELU = range(5)
_STAGE = {"batchnorm2d": _BN, "mul": _GATE, "add": _ADD, "relu": _RELU}
# the kernel's stage flags
_FLAG = {_BIAS: 1, _BN: 2, _GATE: 4, _ADD: 8, _RELU: 16}


@dataclasses.dataclass(frozen=True)
class Chain:
    """One fused epilogue: node indices in call order, the data input
    ``x`` (the biased convolution's output when ``conv`` is set: the
    convolution then runs without its bias), the last node's output
    ``out``, and its stages.  ``gate`` and ``residual`` are (tensor id,
    whether it is the node's first operand)."""
    nodes: Tuple[int, ...]
    x: int
    out: int
    conv: Optional[int] = None
    bn: Optional[int] = None
    gate: Optional[Tuple[int, bool]] = None
    residual: Optional[Tuple[int, bool]] = None
    relu: bool = False


@dataclasses.dataclass(frozen=True)
class Plan:
    """A keep-limited forward: ``steps`` in order, each ("node", node
    index), ("conv", node index: the convolution without its bias) or
    ("chain", Chain), run at the chain's last node; ``frees[i]``: the
    tensors no later step reads, dropped after step i.  ``n_bn``:
    BatchNorm nodes the forward applies, ``n_bn_fused`` of them in a
    chain."""
    steps: Tuple[Tuple[str, object], ...]
    frees: Tuple[Tuple[int, ...], ...]
    chains: Tuple[Chain, ...]
    n_bn: int
    n_bn_fused: int


def engages(x):
    """Whether a forward of ``x`` fuses its chains: on the CPU (the plain
    version) and for a float32 tensor on a card (the kernel)."""
    return x.device.type == "cpu" or x.dtype == torch.float32


@functools.lru_cache(maxsize=64)
def conv_nodes(graph):
    """(node index, param name) of the graph's convolutions."""
    return tuple((ni, n.pname) for ni, n in enumerate(graph.nodes)
                 if n.op == "conv2d")


def biased(graph, params):
    """The indices of the convolutions whose ``params`` carry a bias."""
    return frozenset(ni for ni, pn in conv_nodes(graph)
                     if params.get(pn, {}).get("b") is not None)


@functools.lru_cache(maxsize=64)
def plan(graph, keep, biased_convs=frozenset(), fuse=True):
    """The ``Plan`` of a forward of ``graph`` that keeps the tensors
    ``keep`` (a tuple), with the convolutions ``biased_convs`` carrying a
    bias; ``fuse=False`` forms no chain."""
    nodes, want = graph.nodes, set(keep)

    def single(t):
        return t not in want and len(graph.readers(t)) == 1

    chains, owner = [], {}
    for ni in range(len(nodes) if fuse else 0):
        if ni not in owner:
            c = _chain_from(nodes, ni, single, graph.readers, biased_convs,
                            owner)
            if c is not None:
                chains.append(c)
                owner.update(dict.fromkeys(c.nodes, c))

    def run_at(ni):
        c = owner.get(ni)
        return ni if c is None or ni == c.conv else c.nodes[-1]

    producer = {n.out: ni for ni, n in enumerate(nodes)}
    stop = max((run_at(producer[t]) if t in producer else len(nodes) - 1
                for t in want), default=0)
    # the nodes the forward runs: up to the last kept tensor, less the
    # chains that end beyond it (nothing before it reads them)
    runs = [ni for ni in range(stop + 1)
            if ni not in owner or owner[ni].nodes[-1] <= stop]
    steps, at = [], []
    for ni in runs:
        c = owner.get(ni)
        if c is None:
            steps.append(("node", ni))
        elif ni == c.conv:
            steps.append(("conv", ni))
        elif ni == c.nodes[-1]:
            steps.append(("chain", c))
        else:
            continue
        at.append(ni)
    # a tensor is dropped after the last step that reads it
    last = {}
    for ni in runs:
        for t in nodes[ni].ins:
            last[t] = max(last.get(t, -1), run_at(ni))
    frees = [[] for _ in steps]
    pos = {ni: i for i, ni in enumerate(at)}
    for t, ni in last.items():
        if t not in want:
            frees[pos[ni]].append(t)
    bn = [ni for ni in runs if nodes[ni].op == "batchnorm2d"]
    return Plan(steps=tuple(steps), frees=tuple(map(tuple, frees)),
                chains=tuple(chains), n_bn=len(bn),
                n_bn_fused=sum(ni in owner for ni in bn))


def _chain_from(nodes, ni, single, readers, biased_convs, owner):
    """The longest chain that starts at node ``ni`` and takes no node of
    an earlier chain (``owner``), or None."""
    node = nodes[ni]
    st = {"nodes": [ni], "out": node.out}
    if node.op == "conv2d":
        if ni not in biased_convs or not single(node.out):
            return None
        st.update(x=node.out, conv=ni)
        level = _BIAS
    elif node.op in _STAGE:
        level = _STAGE[node.op]
        # a chain that starts at a gate multiply takes its first operand
        # for the gate, as the squeeze-excite block's mul(se, y) has it
        st["x"] = node.ins[1] if level == _GATE else node.ins[0]
        _absorb(st, ni, node, level, st["x"])
    else:
        return None
    cur = node.out
    while single(cur):
        (r,) = readers(cur)
        nxt = nodes[r]
        if r in owner or _STAGE.get(nxt.op, -1) <= level:
            break
        level = _STAGE[nxt.op]
        st["nodes"].append(r)
        _absorb(st, r, nxt, level, cur)
        st["out"] = cur = nxt.out
    if "bn" not in st and len(st["nodes"]) < 2:
        return None
    st["nodes"] = tuple(st["nodes"])
    return Chain(**st)


def _absorb(st, ni, node, level, data):
    """Add node ``ni``'s stage to the chain ``st`` whose data is the
    tensor ``data``."""
    if level == _BN:
        st["bn"] = ni
    elif level in (_GATE, _ADD):
        other = node.ins[1] if node.ins[0] == data else node.ins[0]
        st["gate" if level == _GATE else "residual"] = (
            other, node.ins[1] == data)
    else:
        st["relu"] = True


def chain_args(chain, graph, params, values):
    """(x, keyword arguments) of ``fused_epilogue`` for the chain, from the
    forward's ``values``."""
    nodes = graph.nodes
    kw = {"relu": chain.relu}
    if chain.conv is not None:
        kw["bias"] = params[nodes[chain.conv].pname]["b"]
    if chain.bn is not None:
        node = nodes[chain.bn]
        kw["bn"] = params[node.pname]
        kw["eps"] = node.attrs_dict.get("eps", 1e-5)
    if chain.gate is not None:
        kw["gate"], kw["gate_first"] = values[chain.gate[0]], chain.gate[1]
    if chain.residual is not None:
        kw["residual"] = values[chain.residual[0]]
        kw["residual_first"] = chain.residual[1]
    return values[chain.x], kw


def run_chain(chain, graph, params, values):
    """The chain's output from the forward's ``values``."""
    x, kw = chain_args(chain, graph, params, values)
    return fused_epilogue(x, **kw)


# ---------------------------------------------------------------------------
# One chain: the plain version and the kernel
# ---------------------------------------------------------------------------


def fused_epilogue_reference(x, *, bias=None, bn=None, eps=1e-5, gate=None,
                             gate_first=True, residual=None,
                             residual_first=False, relu=False):
    """Plain version: the eager ops of the chain, in order and with the
    graph's operand order.  ``bn``: {"mean", "var", "gamma", "beta"}."""
    y = x
    if bias is not None:
        y = y + bias[None, :, None, None]  # as ops.conv2d adds it
    if bn is not None:
        y = O.batchnorm2d(bn, (y,), eps=eps)
    if gate is not None:
        y = O.mul({}, (gate, y) if gate_first else (y, gate))
    if residual is not None:
        y = O.add({}, (residual, y) if residual_first else (y, residual))
    if relu:
        y = O.relu({}, (y,))
    return y


_BN_KEYS = ("mean", "var", "gamma", "beta")


def _vectors(bias, bn):
    """The per-channel vectors in the kernel's order (bias, mean, var,
    gamma, beta), None where the chain has no such stage."""
    return [bias] + [None if bn is None else bn[k] for k in _BN_KEYS]


def _check(x, bias, bn, gate, residual):
    """Refuse what the kernel does not take; returns whether ``x`` walks
    as channels_last (a [N, C, 1, 1] ``x`` does: both layouts map its
    elements alike)."""
    if x.ndim != 4:
        raise ValueError(f"the epilogue takes [N, C, H, W], got "
                         f"{tuple(x.shape)}")
    n, c, h, w = x.shape
    for v in _vectors(bias, bn):
        if v is not None and (tuple(v.shape) != (c,)
                              or not v.is_contiguous()):
            raise ValueError(f"a per-channel vector must be [{c}] and "
                             f"contiguous, got {tuple(v.shape)} strides "
                             f"{v.stride()}")
    if gate is not None and tuple(gate.shape) != (n, c, 1, 1):
        raise ValueError(f"the gate must be [{n}, {c}, 1, 1], got "
                         f"{tuple(gate.shape)}")
    if x.is_contiguous():
        fmt = torch.contiguous_format
    elif x.is_contiguous(memory_format=torch.channels_last):
        fmt = torch.channels_last
    else:
        raise ValueError(f"x must be dense NCHW or channels_last, got "
                         f"strides {x.stride()}")
    if residual is not None and (residual.shape != x.shape or not
                                 residual.is_contiguous(memory_format=fmt)):
        raise ValueError(f"the residual must be {tuple(x.shape)} laid out "
                         f"as x ({x.stride()}), got {tuple(residual.shape)}"
                         f" strides {residual.stride()}")
    return h * w == 1 or fmt == torch.channels_last


def fused_epilogue(x, *, bias=None, bn=None, eps=1e-5, gate=None,
                   gate_first=True, residual=None, residual_first=False,
                   relu=False):
    """The chain ``x`` [N, C, H, W] (+ bias [C]) -> BatchNorm (``bn``:
    {"mean", "var", "gamma", "beta"}, each [C], and ``eps``) -> * gate
    [N, C, 1, 1] -> + residual [N, C, H, W] -> ReLU, each stage optional,
    equal to ``fused_epilogue_reference`` bit for bit.  ``x`` is dense
    NCHW or channels_last and the residual is laid out as ``x``; the
    output is too, as the eager chain lays it out then.

    A CUDA float32 ``x`` launches the Hopper kernel on the current stream,
    counted in ``fused_epilogue.launches`` (``profiling.launched``: a
    launch into a captured CUDA graph counts at each replay of the graph,
    ``replay.Captured``).  A CPU ``x`` runs the plain version.  Anything
    else raises."""
    nhwc = _check(x, bias, bn, gate, residual)
    if x.device.type == "cpu":
        return fused_epilogue_reference(
            x, bias=bias, bn=bn, eps=eps, gate=gate, gate_first=gate_first,
            residual=residual, residual_first=residual_first, relu=relu)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    vecs = _vectors(bias, bn)
    for t in [x, gate, residual] + vecs:
        if t is not None and (t.dtype != torch.float32
                              or t.device != x.device):
            raise TypeError(f"the epilogue's kernel takes float32 tensors "
                            f"on {x.device}, got {t.dtype} on {t.device}")
    flags = sum(_FLAG[s] for s, on in (
        (_BIAS, bias is not None), (_BN, bn is not None),
        (_GATE, gate is not None), (_ADD, residual is not None),
        (_RELU, relu)) if on)
    N, C, H, W = x.shape
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    if gate is not None:
        gate = gate.reshape(N, C).contiguous()
    ptrs = [x] + vecs + [gate, residual, out]
    aligned = all(t.data_ptr() % 16 == 0 for t in ptrs if t is not None)
    fn = _entry()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(*(None if t is None else t.data_ptr() for t in ptrs),
                 eps, N, C, H * W, int(nhwc), flags, int(aligned), stream)
        if err != 0:
            raise RuntimeError(f"fused_epilogue kernel launch failed: CUDA "
                               f"error {err}")
        launched(fused_epilogue)
    return out


fused_epilogue.launches = 0


@functools.cache
def _entry():
    """The kernel's C entry, loaded (and built) once, its types set."""
    from xfr_torch import kernels

    fn = kernels.load("fused_epilogue").fused_epilogue_f32
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [p] * 9 + [f] + [i] * 6 + [p]
    fn.restype = ctypes.c_int
    return fn
