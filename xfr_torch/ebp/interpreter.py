"""Excitation-backprop interpreter over the graph IR (port of
xfr_tpu/ebp/interpreter.py).

Two forward passes and one explicit, statically scheduled backward walk:

  pass 1 (clean):     values[t]  — the ordinary forward, original weights.
                      a(t) = relu(values[t]) is the reference's self.A.
  pass 2 (positive):  posvals[t] — each *hooked* call computes with ReLU'd
                      weights from the overridden input a(t_in); unhooked
                      functional ops flow through naturally.
                      x(t) = relu(posvals[t]) is the reference's self.X.
  backward:           walk nodes in descending call order.  Right before a
                      node's vjp runs, its output tensor's hook chain fires
                      (ascending consumer order), computing
                      p = a * relu(z), optionally overridden by a prior, and
                      rewriting the gradient per the subtree mode.  Affine
                      vjps use positive weights; nonlinear vjps linearize
                      at clean values.

Ported: the single walk (``ebp``).  The batched prior-injected sweep
(``ebp_backward_allevents``), ``natural_backward`` and the traced
``inject_spec`` one-hot of the weighted-subtree path wait for the
whitebox slice.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from xfr_torch import ops as O
from xfr_torch.graph import GraphDef

VALID_SUBTREE_MODES = ("affineonly", "affineonly_with_prior", "norelu", "all")


def _relu(x):
    return torch.clamp(x, min=0)


@torch.no_grad()
def forward_clean(graph: GraphDef, params, x, keep: Optional[Sequence[int]]
                  = None):
    """Pass 1: ordinary forward.  Returns per-tensor values.

    ``keep``: tensor ids the caller needs.  When given, the walk stops once
    they are computed and frees every other value after its last reader
    (the port's stand-in for XLA's dead-code elimination and buffer
    reuse); the returned list then holds only the kept tensors."""
    values = [None] * graph.n_tensors
    values[graph.input_id] = x
    want = None if keep is None else set(keep)
    todo = None if keep is None else set(want)
    for ni, node in enumerate(graph.nodes):
        p = params.get(node.pname, {}) if node.pname else {}
        xs = tuple(values[i] for i in node.ins)
        values[node.out] = O.apply_op(node.op, p, xs, node.attrs_dict)
        if want is None:
            continue
        todo.discard(node.out)
        if not todo:
            break
        for i in node.ins:
            if graph.last_use.get(i) == ni and i not in want:
                values[i] = None
    if want is not None:
        values = [v if t in want else None for t, v in enumerate(values)]
    return values


@torch.no_grad()
def forward_positive(graph: GraphDef, params, values, with_bias=False):
    """Pass 2: positive-weight forward with per-hooked-call input override.

    Each hooked call's input is replaced by a = relu(clean input) before
    computing with W+ weights; the value that *naturally* arrived at the
    call is what the reference records as X.  Unhooked ops compute on the
    flowing positive values without override.
    """
    posvals = [None] * graph.n_tensors
    posvals[graph.input_id] = values[graph.input_id]
    for node in graph.nodes:
        p = params.get(node.pname, {}) if node.pname else {}
        if node.hooked:
            p = O.positive_params(node.op, p, with_bias=with_bias)
            xs = tuple(_relu(values[i]) for i in node.ins)
        else:
            xs = tuple(posvals[i] for i in node.ins)
        posvals[node.out] = O.apply_op(node.op, p, xs, node.attrs_dict)
    return posvals


def _check_mode(graph, mode):
    if mode not in VALID_SUBTREE_MODES:
        raise ValueError(f'invalid subtree mode "{mode}"')
    for ev in graph.events:
        if ev.is_special:
            raise ValueError(
                'layer "%s" is a special case '
                "(https://arxiv.org/pdf/1608.00507.pdf, eq 5) and is not "
                "supported for EBP" % ev.tag)


def _apply_event_rule(ev, mode, z, a, xpos, eps, prior):
    """One tensor-hook firing: compute the MWP p and the rewritten gradient.
    ``prior`` is a static override tensor (or None)."""
    zh = _relu(z)
    p = a * zh
    has_prior = prior is not None
    if has_prior:
        p = torch.broadcast_to(prior, p.shape).to(p.dtype)

    if mode == "affineonly":
        g2 = p / (xpos + eps) if ev.is_affine else z
    elif mode == "affineonly_with_prior":
        # zh/p masked where a prior is present
        if has_prior:
            pm = (p > 0) * p
            zm = (p > 0) * z
        else:
            pm, zm = p, zh
        g2 = pm / (xpos + eps) if ev.is_affine else zm
    elif mode == "norelu":
        g2 = z if (ev.is_poolrelu and has_prior) else p / (xpos + eps)
    elif mode == "all":
        g2 = p / (xpos + eps)
    else:
        raise ValueError(f'invalid subtree mode "{mode}"')
    return g2, p


@torch.no_grad()
def ebp_backward(
    graph: GraphDef,
    params,
    values,
    posvals,
    cotangent,
    *,
    subtree_mode: str,
    eps: float = 1e-16,
    with_bias: bool = False,
    keep: Optional[Sequence[int]] = None,
    priors: Optional[Dict[int, torch.Tensor]] = None,
    start_node: Optional[int] = None,
) -> Dict[int, torch.Tensor]:
    """EBP backward walk.  Returns {event_idx: P} for requested events.

    Args:
      cotangent: gradient seeded at the graph output (the reference's
        ``Xn.backward(Pn)``).
      keep: event indices whose MWP to return (default: all).
      priors: static per-event override tensors (reference self.P_prior).
      start_node: begin the walk at this node index instead of the output
        (truncated walk for prior-injected runs with zero cotangent:
        everything above contributes zero gradient, so missing grads are
        treated as zeros; the injected event's node must be <= start_node —
        see GraphDef.event_node).
    """
    _check_mode(graph, subtree_mode)
    priors = priors or {}
    keep_set = set(range(graph.n_events)) if keep is None else set(
        k % graph.n_events for k in keep)

    grads = [None] * graph.n_tensors
    grads[graph.output_id] = cotangent
    out: Dict[int, torch.Tensor] = {}
    truncated = start_node is not None
    first_node = (len(graph.nodes) - 1 if start_node is None
                  else min(start_node, len(graph.nodes) - 1))

    # Event lookup: (tensor, consumer, slot) -> Event
    ev_by_key = {(e.tensor, e.consumer, e.slot): e for e in graph.events}

    def _finalize(t):
        g = grads[t]
        if g is None:
            if not truncated:
                return
            g = torch.zeros_like(values[t])
        for (ci, slot, at, xt) in graph.hooks_on(t):
            ev = ev_by_key[(t, ci, slot)]
            a = _relu(values[at])
            xp = _relu(posvals[xt])
            g, p = _apply_event_rule(ev, subtree_mode, g, a, xp, eps,
                                     priors.get(ev.idx))
            if ev.idx in keep_set:
                out[ev.idx] = p
        grads[t] = g

    for ni in range(first_node, -1, -1):
        node = graph.nodes[ni]
        _finalize(node.out)
        g = grads[node.out]
        if g is None:
            continue
        grads[node.out] = None  # consumed: nothing reads it again
        p = params.get(node.pname, {}) if node.pname else {}
        if node.hooked:
            p = O.positive_params(node.op, p, with_bias=with_bias)
        xs = tuple(values[i] for i in node.ins)
        contribs = O.op_vjp(node.op, p, xs, node.attrs_dict, g)
        for i, c in zip(node.ins, contribs):
            grads[i] = c if grads[i] is None else grads[i] + c
    _finalize(graph.input_id)
    return out


def ebp(graph, params, x, Pn, *, subtree_mode, eps=1e-16, with_bias=False,
        keep=None, priors=None):
    """Full EBP: both forward passes + backward.  Returns {event_idx: P}."""
    values = forward_clean(graph, params, x)
    posvals = forward_positive(graph, params, values, with_bias=with_bias)
    return ebp_backward(
        graph, params, values, posvals, Pn,
        subtree_mode=subtree_mode, eps=eps, with_bias=with_bias,
        keep=keep, priors=priors)
