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

Ported: the single walk (``ebp``, ``ebp_backward``, with the traced
``inject_spec`` one-hot of the per-probe weighted-subtree path),
``natural_backward`` and the batched prior-injected sweep
(``ebp_backward_allevents``, bucketed and cascaded).

Eager torch keeps no buffer XLA would have reused or dropped, so the walks
here (a) free each gradient once its node has consumed it, (b) stop as
soon as every requested event has fired, and (c) take a cotangent with a
leading row axis (``jax.vmap`` of the JAX walk over cotangents), walking
all rows in one batch through ``ops.op_vjp_rows``.  A single walk is one
row: ``ebp`` adds the axis and strips it again.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Sequence

import torch

from xfr_torch import ops as O
from xfr_torch.graph import GraphDef
from xfr_torch.utils.profiling import count

VALID_SUBTREE_MODES = ("affineonly", "affineonly_with_prior", "norelu", "all")


def _relu(x):
    return torch.clamp(x, min=0)


def forward_values(graph: GraphDef, params, x,
                   keep: Optional[Sequence[int]] = None):
    """The ordinary forward, carrying autograd: per-tensor values.  The
    trainer differentiates through it (``train.finetune``); every EBP
    caller goes through ``forward_clean``.

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
def forward_clean(graph: GraphDef, params, x, keep: Optional[Sequence[int]]
                  = None):
    """Pass 1: ``forward_values`` without autograd.  While a profiler
    records, counts the SE gate multiplies of the forward
    (``xfr.enc.se_gates``: one a row a gated block)."""
    if graph.n_gates:
        count("xfr.enc.se_gates", graph.n_gates * x.shape[0])
    return forward_values(graph, params, x, keep)


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


def _inject(ev, p, inject_spec):
    """The traced one-hot injection over a walk's rows: row r holds
    (event id, flat element, value) in ``inject_spec``; where its event is
    ``ev``, its p becomes the one-hot of that value at that element.
    Returns (p, [rows, 1, ...] presence mask)."""
    ev_ids, elems, vals = inject_spec
    bshape = (-1,) + (1,) * (p.ndim - 1)
    here = (ev_ids == ev.idx).reshape(bshape)
    iota = torch.arange(p[0].numel(), dtype=elems.dtype,
                        device=p.device).reshape(p.shape[1:])
    onehot = torch.where(iota[None] == elems.reshape(bshape),
                         vals.to(p.dtype).reshape(bshape), 0)
    return torch.where(here, onehot, p), here


def _apply_event_rule(ev, mode, z, a, xpos, eps, prior, inject_spec=None):
    """One tensor-hook firing: compute the MWP p and the rewritten gradient.
    ``prior`` is a static override tensor (or None).  ``inject_spec``
    optionally gives each row a dynamic one-hot override (``_inject``);
    presence is then per row, a [rows, 1, ...] mask."""
    zh = _relu(z)
    p = a * zh
    has_prior = prior is not None
    if has_prior:
        p = torch.broadcast_to(prior, p.shape).to(p.dtype)
    if inject_spec is not None:
        p, here = _inject(ev, p, inject_spec)
        if not has_prior:
            has_prior = here

    if mode == "affineonly":
        g2 = p / (xpos + eps) if ev.is_affine else z
    elif mode == "affineonly_with_prior":
        # zh/p masked where a prior is present
        if has_prior is True:
            pm = (p > 0) * p
            zm = (p > 0) * z
        elif has_prior is False:
            pm, zm = p, zh
        else:
            pm = torch.where(has_prior, (p > 0) * p, p)
            zm = torch.where(has_prior, (p > 0) * z, zh)
        g2 = pm / (xpos + eps) if ev.is_affine else zm
    elif mode == "norelu":
        g2 = p / (xpos + eps)
        if ev.is_poolrelu and has_prior is True:
            g2 = z
        elif ev.is_poolrelu and has_prior is not False:
            g2 = torch.where(has_prior, z, g2)
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
    inject_spec=None,
    start_node: Optional[int] = None,
    reduce: Optional[Callable[[int, torch.Tensor], torch.Tensor]] = None,
) -> Dict[int, torch.Tensor]:
    """EBP backward walk, one per cotangent row.  Returns {event_idx: P}
    for requested events, each P with the cotangent's leading row axis.

    Args:
      cotangent: [R, *out] gradients seeded at the graph output (the
        reference's ``Xn.backward(Pn)``); row r is its own walk, as
        ``jax.vmap`` of the JAX walk over cotangents.
      keep: event indices whose MWP to return (default: all).
      priors: static per-event override tensors (reference self.P_prior).
      inject_spec: (event ids, flat elements, values), one of each per
        cotangent row: the dynamic one-hot prior of the per-probe
        weighted-subtree path (the JAX package's traced injection under
        ``jax.vmap``), each row injected at its own event.
      start_node: begin the walk at this node index instead of the output
        (truncated walk for prior-injected runs with zero cotangent:
        everything above contributes zero gradient, so missing grads are
        treated as zeros; the injected event's node must be <= start_node —
        see GraphDef.event_node).
      reduce: ``reduce(event_idx, P)`` is kept in place of ``P`` when the
        event fires, so a caller that needs a few elements of each MWP
        does not hold every event's full tensor.
    """
    _check_mode(graph, subtree_mode)
    priors = priors or {}
    keep_set = set(range(graph.n_events)) if keep is None else set(
        k % graph.n_events for k in keep)

    grads = [None] * graph.n_tensors
    grads[graph.output_id] = cotangent
    rows = cotangent.shape[0]
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
            g = values[t].new_zeros((rows,) + tuple(values[t].shape))
        for (ci, slot, at, xt) in graph.hooks_on(t):
            ev = ev_by_key[(t, ci, slot)]
            a = _relu(values[at])
            xp = _relu(posvals[xt])
            g, p = _apply_event_rule(ev, subtree_mode, g, a, xp, eps,
                                     priors.get(ev.idx), inject_spec)
            if ev.idx in keep_set:
                out[ev.idx] = p if reduce is None else reduce(ev.idx, p)
        grads[t] = g

    for ni in range(first_node, -1, -1):
        node = graph.nodes[ni]
        _finalize(node.out)
        if len(out) == len(keep_set):
            return out  # nothing below reaches a requested event
        g = grads[node.out]
        if g is None:
            continue
        grads[node.out] = None  # consumed: nothing reads it again
        p = params.get(node.pname, {}) if node.pname else {}
        if node.hooked:
            p = O.positive_params(node.op, p, with_bias=with_bias)
        xs = tuple(values[i] for i in node.ins)
        contribs = O.op_vjp_rows(node.op, p, xs, node.attrs_dict, g)
        for i, c in zip(node.ins, contribs):
            grads[i] = c if grads[i] is None else grads[i] + c
    _finalize(graph.input_id)
    return out


def _positive_node_params(graph, params, with_bias):
    """Per-node params of an EBP walk, W+ swapped in for hooked nodes once
    (a walk over many rows or probes reuses them)."""
    out = []
    for node in graph.nodes:
        p = params.get(node.pname, {}) if node.pname else {}
        out.append(O.positive_params(node.op, p, with_bias=with_bias)
                   if node.hooked else p)
    return out


def _sweep_event_rule(ev, mode, z, a, xp, eps, inj):
    """One hook firing of the candidate sweep over [rows, ...] gradients:
    p = a * relu(z) for every row, the injected one-hot written into row
    ``inj[0]`` when this event is that row's candidate, and the gradient
    rewritten per subtree mode (where a prior is present, the injected row
    follows the prior branch of ``_apply_event_rule``).  Returns (g2, p)."""
    zh = _relu(z)
    p = a * zh  # [rows, {1|P}, ...], this event's own tensor
    r = None
    if inj is not None:
        r, onehot = inj
        p[r] = onehot
    if mode == "affineonly":
        return (p / (xp + eps) if ev.is_affine else z), p
    if mode == "affineonly_with_prior":
        # the injected row masks p and zh by p > 0
        if ev.is_affine:
            g2 = p / (xp + eps)
            if r is not None:
                g2[r] = ((p[r] > 0) * p[r]) / (xp + eps)
        else:
            g2 = zh
            if r is not None:
                g2[r] = (p[r] > 0) * z[r]
        return g2, p
    g2 = p / (xp + eps)
    if mode == "norelu" and ev.is_poolrelu and r is not None:
        g2[r] = z[r]
    return g2, p


def _bucket_ranges(n_cand, n_buckets):
    """Contiguous buckets of candidate rows (ascending event index)."""
    n_buckets = max(1, min(n_buckets, n_cand))
    size = -(-n_cand // n_buckets)
    return [(lo, min(lo + size, n_cand)) for lo in range(0, n_cand, size)]


def _zero_plane_rows(graph, values, n):
    """``n`` zero rows of the sweep's output: the channel-summed saliency
    plane [n, 1, H, W] in float32."""
    v = values[graph.events[graph.n_events - 2].tensor]
    return v.new_zeros((n, v.shape[0]) + tuple(v.shape[2:]),
                       dtype=torch.float32)


def row_shard_order(n_cand, n_buckets, count):
    """For the outputs of ``ebp_backward_allevents(row_shard=(r, count))``
    of ranks r = 0..count-1 concatenated in rank order: the position of
    each candidate row 0..n_cand-1 in that concatenation."""
    ranges = _bucket_ranges(n_cand, n_buckets)
    pers = [-(-(hi - lo) // count) for lo, hi in ranges]
    local = sum(pers)
    order, off = [], 0
    for (lo, hi), per in zip(ranges, pers):
        for j in range(hi - lo):
            order.append((j // per) * local + off + j % per)
        off += per
    return order


@torch.no_grad()
def ebp_backward_allevents(
    graph: GraphDef,
    params,
    values,
    posvals,
    elems,
    vals,
    *,
    subtree_mode: str,
    eps: float = 1e-16,
    with_bias: bool = False,
    n_buckets: int = 1,
    cascade: bool = False,
    row_shard=None,
):
    """Batched prior-injected backward: one walk row per candidate event.

    The weighted-subtree sweep evaluates a one-hot prior injection at
    EVERY event 0..n_events-2.  Because candidate k injects exactly at
    event k, the injection row at each event is static, so the walk is
    natively batched over candidate rows and event k writes one row.

    ``elems``/``vals`` are [n_events-1] tensors: flat element index and
    injection value per candidate (row k = event k).  With PROBE-BATCHED
    captures (``values``/``posvals`` leading dim P > 1) pass
    [n_events-1, P] tensors: every op then carries a [rows, P, ...] batch
    and the one-hot indexes each probe's own [C,H,W] plane.

    ``n_buckets`` splits the candidate rows into contiguous event ranges.
    ``graph.event_node`` is non-increasing in event index, so rows of a
    bucket share a truncation point: with a zero output cotangent the
    gradient above the bucket's first node is identically zero and those
    vjps are skipped.  All buckets share ``values``/``posvals``.

    ``cascade`` (with more than one bucket) merges the buckets' walks
    below their shared frontiers into ONE full-depth walk whose row batch
    grows bucket by bucket: identical per-row math (the bucketed walk is
    its row-sliced restriction), ~(n_buckets+1)/2 x fewer walk ops.

    ``row_shard=(index, count)`` walks only this rank's share of the
    candidate rows, as the JAX package's sharding constraint splits every
    bucket over the mesh's 'dp' axis: bucket [lo, hi) gives each of
    ``count`` ranks ceil((hi-lo)/count) rows, rank ``index`` the
    ``index``-th such run, and pads its run with zero rows to that length
    (a slice of all rows would give one rank every deep walk).  Every
    rank then returns the same shape; ``row_shard_order`` maps the ranks'
    outputs, gathered in rank order, back to event order.  Cascade is off
    under it (the growing row batch has no static split), and the
    captures must not be probe-batched.

    Returns (P_out [n_events-1, {1|P}, H, W], maxes) where P_out is the
    channel-summed MWP at the saliency plane (event n_events-2) and maxes
    are per-row map maxima ([n_events-1], or [n_events-1, P] for
    probe-batched captures) for the validity selection.  The walk stops
    once the saliency plane's event has fired: nothing below it is read.
    """
    _check_mode(graph, subtree_mode)
    n_cand = graph.n_events - 1
    kk = graph.n_events - 2
    batched = elems.ndim == 2
    if row_shard is not None and batched:
        raise ValueError("row_shard needs one probe's captures")
    node_params = _positive_node_params(graph, params, with_bias)

    ev_by_key = {(e.tensor, e.consumer, e.slot): e for e in graph.events}
    bucket_ranges = _bucket_ranges(n_cand, n_buckets)

    outs = []

    def _onehot(ev, rshape, dtype):
        """The injected plane of candidate ``ev``: its value at its flat
        element, per probe when the captures are probe-batched."""
        if not batched:
            iota = torch.arange(math.prod(rshape), dtype=elems.dtype,
                                device=elems.device).reshape(rshape)
            return torch.where(iota == elems[ev.idx],
                               vals[ev.idx].to(dtype), 0)
        npr, per = rshape[0], math.prod(rshape[1:])
        iota = torch.arange(per, dtype=elems.dtype,
                            device=elems.device).reshape(rshape[1:])
        bshape = (npr,) + (1,) * (len(rshape) - 1)
        return torch.where(iota[None] == elems[ev.idx].reshape(bshape),
                           vals[ev.idx].to(dtype).reshape(bshape), 0)

    def _make_finalize(grads, bounds):
        """Hook-event processor for a walk carrying candidate rows
        ``bounds[0]:bounds[1]`` (a bucket's range, or [0, live) for the
        cascade, which grows ``bounds`` at bucket frontiers)."""

        def _finalize(t):
            lo, hi = bounds
            g = grads[t]
            for (ci, slot, at, xt) in graph.hooks_on(t):
                ev = ev_by_key[(t, ci, slot)]
                if g is None:
                    # above/at the truncation frontier: gradient is
                    # identically zero for every live row
                    if not (lo <= ev.idx < hi):
                        continue
                    g = values[t].new_zeros((hi - lo,)
                                            + tuple(values[t].shape))
                inj = None
                if lo <= ev.idx < hi:
                    inj = (ev.idx - lo,
                           _onehot(ev, tuple(g.shape[1:]), g.dtype))
                g2, p = _sweep_event_rule(ev, subtree_mode, g,
                                          _relu(values[at]),
                                          _relu(posvals[xt]), eps, inj)
                if ev.idx == kk:
                    outs.append(p.sum(dim=2, dtype=torch.float32))
                g = g2
            grads[t] = g

        return _finalize

    def _walk_node(ni, grads, fin):
        """One node of a walk; False once the saliency plane has fired."""
        node = graph.nodes[ni]
        fin(node.out)
        if ni == graph.event_node[kk] and _fired(node.out):
            return False
        g = grads[node.out]
        if g is None:
            return True
        grads[node.out] = None  # consumed: nothing reads it again
        xs = tuple(values[i] for i in node.ins)
        contribs = O.op_vjp_rows(node.op, node_params[ni], xs,
                                 node.attrs_dict, g)
        for i, c in zip(node.ins, contribs):
            grads[i] = c if grads[i] is None else grads[i] + c
        return True

    def _fired(t):
        return any(ev_by_key[(t, ci, slot)].idx == kk
                   for (ci, slot, _, _) in graph.hooks_on(t))

    if cascade and row_shard is None and len(bucket_ranges) > 1:
        # One full-depth walk whose candidate-row batch GROWS at each
        # bucket frontier: pad every live gradient with the joining
        # bucket's zero rows and keep walking.  Rows still join only at
        # their own bucket's frontier, so the zero-row work is that of the
        # bucketed walk.
        joins = {}
        for lo, hi in bucket_ranges:
            sn = graph.event_node[lo]
            joins[sn] = max(joins.get(sn, 0), hi)
        grads = [None] * graph.n_tensors
        bounds = [0, 0]  # live candidate-row range, grown at frontiers
        fin = _make_finalize(grads, bounds)
        for ni in range(graph.event_node[0], -1, -1):
            new_hi = joins.get(ni, 0)
            if new_hi > bounds[1]:
                for t, g in enumerate(grads):
                    if g is not None:
                        grads[t] = torch.cat([g, g.new_zeros(
                            (new_hi - g.shape[0],) + tuple(g.shape[1:]))])
                bounds[1] = new_hi
            if not _walk_node(ni, grads, fin):
                break
        else:
            fin(graph.input_id)
    else:
        for lo, hi in bucket_ranges:
            if row_shard is not None:
                # this rank's run of the bucket, padded below to ``per``
                index, count = row_shard
                per = -(-(hi - lo) // count)
                n_out = len(outs)
                lo, hi = lo + index * per, min(lo + (index + 1) * per, hi)
                if lo >= hi:
                    outs.append(_zero_plane_rows(graph, values, per))
                    continue
            grads = [None] * graph.n_tensors
            fin = _make_finalize(grads, [lo, hi])
            for ni in range(graph.event_node[lo], -1, -1):
                if not _walk_node(ni, grads, fin):
                    break
            else:
                fin(graph.input_id)
            if row_shard is not None and hi - lo < per:
                outs[n_out] = torch.cat([outs[n_out], _zero_plane_rows(
                    graph, values, per - (hi - lo))])

    P_out = torch.cat(outs, dim=0)  # [n_cand, {1|P}, H, W]
    if batched:  # probe-batched: per-(row, probe) maxima
        return P_out, P_out.amax(dim=(2, 3))
    return P_out, P_out.amax(dim=(1, 2, 3))


@torch.no_grad()
def natural_backward(
    graph: GraphDef,
    params,
    values,
    cotangent,
    keep: Optional[Sequence[int]] = None,
    *,
    reduce: Optional[Callable[[int, torch.Tensor], torch.Tensor]] = None,
) -> Dict[int, torch.Tensor]:
    """Plain backward collecting raw per-event gradients.

    This is the reference's 'activation'-mode backward, which records dA
    at every hooked input in hook-fire order.  Original weights, no
    gradient rewrite.  Returns {event_idx: dA}; the row-batched
    ``cotangent`` and ``reduce`` as in ``ebp_backward`` (the ranking pass
    reduces each dA to its gated max and argmax as it fires, instead of
    holding every event's gradient).
    """
    keep_set = set(range(graph.n_events)) if keep is None else set(
        k % graph.n_events for k in keep)
    grads = [None] * graph.n_tensors
    grads[graph.output_id] = cotangent
    out: Dict[int, torch.Tensor] = {}
    ev_by_key = {(e.tensor, e.consumer, e.slot): e for e in graph.events}

    def _finalize(t):
        g = grads[t]
        if g is None:
            return
        for (ci, slot, at, xt) in graph.hooks_on(t):
            ev = ev_by_key[(t, ci, slot)]
            if ev.idx in keep_set:
                out[ev.idx] = g if reduce is None else reduce(ev.idx, g)

    for ni in range(len(graph.nodes) - 1, -1, -1):
        node = graph.nodes[ni]
        _finalize(node.out)
        if len(out) == len(keep_set):
            return out  # nothing below reaches a requested event
        g = grads[node.out]
        if g is None:
            continue
        grads[node.out] = None  # consumed: nothing reads it again
        p = params.get(node.pname, {}) if node.pname else {}
        xs = tuple(values[i] for i in node.ins)
        contribs = O.op_vjp_rows(node.op, p, xs, node.attrs_dict, g)
        for i, c in zip(node.ins, contribs):
            grads[i] = c if grads[i] is None else grads[i] + c
    _finalize(graph.input_id)
    return out


def ebp(graph, params, x, Pn, *, subtree_mode, eps=1e-16, with_bias=False,
        keep=None, priors=None):
    """Full EBP: both forward passes + backward.  Returns {event_idx: P}."""
    values = forward_clean(graph, params, x)
    posvals = forward_positive(graph, params, values, with_bias=with_bias)
    out = ebp_backward(
        graph, params, values, posvals, Pn[None],
        subtree_mode=subtree_mode, eps=eps, with_bias=with_bias,
        keep=keep, priors=priors)
    return {k: P[0] for k, P in out.items()}
