"""The weighted-subtree machinery of the port against the JAX package:
the row-batched vjp, ``natural_backward``, the prior-injected candidate
sweep ``ebp_backward_allevents``, ``_percentile_mass_mask``,
``_wsebp_select_merge`` and the argmax tie rule of the ranking pass.

Walks run on the toy net of ``tests/fixtures.make_toy_wbnet`` with the
JAX net's parameters carried across, in float64.  Each test states its
tolerance.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from xfr_tpu.ebp import engine as JE
from xfr_tpu.ebp import interpreter as JI
from tests.fixtures import make_toy_wbnet
from tests.test_torch_ops import OP_CASES
from tests.torch_fixtures import torch_twin

from xfr_torch import ops as TO
from xfr_torch.ebp import engine as TE
from xfr_torch.ebp import interpreter as TI


def _toy_pair(mode, seed=3, num_classes=4):
    jwb = make_toy_wbnet(num_classes=num_classes, seed=seed,
                         subtree_mode=mode)
    twb = torch_twin(jwb, np.float64)
    jparams = {k: {kk: jnp.asarray(vv, jnp.float64) for kk, vv in v.items()}
               for k, v in jwb.net.params.items()}
    return jwb, twb, jparams


# ---------------------------------------------------------------------------
# Row-batched vjp
# ---------------------------------------------------------------------------

ROW_CASES = dict(OP_CASES)
# the stem's maxpool with tied windows (all-zero and repeated values:
# overlapping 3x3/2 windows share their ties) and relu at exactly 0
ROW_CASES["maxpool2d_k3s2p1_ties"] = (
    "maxpool2d", {}, [(2, 3, 9, 8)],
    dict(kernel=(3, 3), stride=(2, 2), padding=(1, 1), ceil_mode=False))
ROW_CASES["identity"] = ("identity", {}, [(2, 3, 4, 4)], {})


@pytest.mark.parametrize("case", sorted(ROW_CASES))
def test_op_vjp_rows_matches_op_vjp_row_by_row(case):
    """Row r of op_vjp_rows equals op_vjp on cotangent row r, float64,
    rtol 1e-12 (the same arithmetic, rows folded into the batch)."""
    op, pshapes, xshapes, attrs = ROW_CASES[case]
    rng = np.random.RandomState(sorted(ROW_CASES).index(case))
    params = {k: torch.from_numpy(rng.randn(*s)) for k, s in pshapes.items()}
    if op == "batchnorm2d":
        params["var"] = params["var"].abs() + 0.5
    xs = [torch.from_numpy(rng.randn(*s)) for s in xshapes]
    if op == "relu":
        xs[0].view(-1)[::5] = 0.0  # exact ties at 0
    if case.endswith("_ties"):
        xs[0] = torch.clamp(torch.round(xs[0]), min=0)  # post-ReLU zeros
    y = TO.apply_op(op, params, tuple(xs), attrs)
    g = torch.from_numpy(rng.randn(3, *y.shape))
    got = TO.op_vjp_rows(op, params, tuple(xs), attrs, g)
    assert len(got) == len(xs)
    for r in range(g.shape[0]):
        want = TO.op_vjp(op, params, tuple(xs), attrs, g[r])
        for a, b in zip(got, want):
            assert a.shape == (g.shape[0],) + tuple(b.shape)
            np.testing.assert_allclose(a[r].numpy(), b.numpy(), rtol=1e-12,
                                       atol=1e-14)


def test_op_vjp_rows_relu_half_at_zero_and_maxpool_accumulates():
    """relu passes 0.5 at exactly 0; the 3x3/2 pad-1 maxpool routes each
    window to the first maximum in its scan order, and windows that share
    it add up (a write, as max_unpool2d does, would keep only one)."""
    x = torch.tensor([[-1.0, 0.0, 2.0]], dtype=torch.float64)
    (g,) = TO.op_vjp_rows("relu", {}, (x,), {}, torch.ones((2, 1, 3),
                                                         dtype=x.dtype))
    np.testing.assert_array_equal(g.numpy(), [[[0.0, 0.5, 1.0]]] * 2)

    attrs = dict(kernel=(3, 3), stride=(2, 2), padding=(1, 1),
                 ceil_mode=False)
    z = np.zeros((5, 5))
    z[1, 1] = 1.0  # in windows (0,0), (0,1), (1,0), (1,1); the rest tie
    (gz,) = TO.op_vjp_rows("maxpool2d", {}, (torch.from_numpy(z)[None,
                                                                  None],),
                           attrs, torch.ones((2, 1, 1, 3, 3),
                                             dtype=torch.float64))
    want = np.zeros((5, 5))
    for i in range(3):
        for j in range(3):
            cells = [(r, c) for r in range(2 * i - 1, 2 * i + 2)
                     for c in range(2 * j - 1, 2 * j + 2)
                     if 0 <= r < 5 and 0 <= c < 5]
            want[max(cells, key=lambda rc: (z[rc], -cells.index(rc)))] += 1
    assert want[1, 1] == 4.0
    for r in range(2):
        np.testing.assert_array_equal(gz[r, 0, 0].numpy(), want)


# ---------------------------------------------------------------------------
# natural_backward and ebp_backward_allevents
# ---------------------------------------------------------------------------


def test_natural_backward_matches_jax():
    """Every event's raw gradient, float64, rtol 1e-10: one row-batched
    walk of two cotangents against a JAX walk of each."""
    jwb, twb, jparams = _toy_pair("all")
    g, tg = jwb.net.graph, twb.net.graph
    rng = np.random.RandomState(1)
    x = rng.rand(2, 3, 224, 224)
    cots = rng.randn(2, 2, 4)
    jv = JI.forward_clean(g, jparams, jnp.asarray(x))
    tv = TI.forward_clean(tg, twb.net.params, torch.from_numpy(x))
    tout = TI.natural_backward(tg, twb.net.params, tv,
                               torch.from_numpy(cots))
    for r in range(2):
        jout = JI.natural_backward(g, jparams, jv, jnp.asarray(cots[r]))
        assert sorted(jout) == sorted(tout) == list(range(g.n_events))
        for k in jout:
            np.testing.assert_allclose(tout[k][r].numpy(),
                                       np.asarray(jout[k]), rtol=1e-10,
                                       atol=1e-14, err_msg=str(k))


def _injections(sizes, batched, rng):
    """Random flat elements and values, one per candidate event."""
    shape = (len(sizes), 2) if batched else (len(sizes),)
    elems = np.stack([rng.randint(0, s, shape[1:]) for s in sizes]
                     ).astype(np.int32).reshape(shape)
    return elems, rng.rand(*shape)


def _torch_captures(twb, x):
    tv = TI.forward_clean(twb.net.graph, twb.net.params, torch.from_numpy(x))
    return tv, TI.forward_positive(twb.net.graph, twb.net.params, tv)


def _event_sizes(graph, values):
    return [int(np.prod(values[e.tensor].shape[1:]))
            for e in graph.events[:graph.n_events - 1]]


@pytest.mark.parametrize("layout", ["single", "probe_batched"])
@pytest.mark.parametrize("n_buckets,cascade", [(1, False), (3, False),
                                               (3, True), (4, False),
                                               (4, True)])
@pytest.mark.parametrize("mode", ["affineonly", "affineonly_with_prior",
                                  "norelu", "all"])
def test_allevents_matches_jax(mode, n_buckets, cascade, layout):
    """The candidate sweep against the JAX walk with the same buckets and
    cascade, float64 captures, rtol 1e-10: both compute the same float64
    values and cast to float32 before the channel sum, as the reference
    does."""
    jwb, twb, jparams = _toy_pair(mode)
    batched = layout == "probe_batched"
    rng = np.random.RandomState(7)
    x = rng.rand(2 if batched else 1, 3, 224, 224)
    g = jwb.net.graph
    jv = JI.forward_clean(g, jparams, jnp.asarray(x))
    jpv = JI.forward_positive(g, jparams, jv)
    tv, tpv = _torch_captures(twb, x)
    elems, vals = _injections(_event_sizes(g, tv), batched, rng)
    kw = dict(subtree_mode=mode, eps=1e-12, n_buckets=n_buckets,
              cascade=cascade)
    jP, jm = JI.ebp_backward_allevents(g, jparams, jv, jpv,
                                       jnp.asarray(elems), jnp.asarray(vals),
                                       **kw)
    tP, tm = TI.ebp_backward_allevents(twb.net.graph, twb.net.params, tv,
                                       tpv, torch.from_numpy(elems),
                                       torch.from_numpy(vals), **kw)
    n = jwb.net.graph.n_events - 1
    assert tuple(tP.shape) == (n, 2 if batched else 1, 56, 56)
    assert tuple(tm.shape) == ((n, 2) if batched else (n,))
    assert np.asarray(jP).max() > 0
    np.testing.assert_allclose(tP.numpy(), np.asarray(jP), rtol=1e-10,
                               atol=0)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-10,
                               atol=0)


@pytest.mark.parametrize("mode", ["all", "norelu"])
def test_cascade_equals_bucketed_float32(mode):
    """The cascaded walk is the bucketed walk's row-sliced restriction:
    in float32, rtol 1e-5 / atol 1e-7 (test_wsebp_sweep.py's tolerance),
    single-probe and probe-batched."""
    jwb = make_toy_wbnet(num_classes=4, seed=3, subtree_mode=mode)
    twb = torch_twin(jwb)
    rng = np.random.RandomState(9)
    for batched in (False, True):
        x = rng.rand(2 if batched else 1, 3, 224, 224).astype(np.float32)
        tv, tpv = _torch_captures(twb, x)
        elems, vals = _injections(_event_sizes(twb.net.graph, tv), batched,
                                  rng)
        outs = [TI.ebp_backward_allevents(
            twb.net.graph, twb.net.params, tv, tpv, torch.from_numpy(elems),
            torch.from_numpy(vals.astype(np.float32)), subtree_mode=mode,
            eps=1e-12, n_buckets=4, cascade=casc) for casc in (False, True)]
        assert outs[0][0].max() > 0
        for a, b in zip(outs[0], outs[1]):
            np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-5,
                                       atol=1e-7)


# ---------------------------------------------------------------------------
# _percentile_mass_mask, _wsebp_select_merge, argmax ties
# ---------------------------------------------------------------------------


def _mass_cases():
    rng = np.random.RandomState(0)
    return [
        rng.rand(7, 13).astype(np.float32),
        np.repeat(rng.rand(40).astype(np.float32), 5).reshape(10, 20),  # ties
        np.zeros((5, 5), np.float32),
        rng.exponential(size=(64, 56, 56)).astype(np.float32),
    ]


@pytest.mark.parametrize("pct", [0.0, 20.0, 80.0, 100.0])
def test_percentile_mass_mask_matches_jax(pct):
    """The bit bisection against JAX's on test_batched_ebp.py's cases
    (ties, all zeros, a dense plane): equal, or differing at most at 2
    boundary-tie elements within 1e-4 of the threshold (float32 sums in
    another order).  The batched form equals the per-plane one."""
    cases = _mass_cases()
    for arr in cases:
        want = np.asarray(JE._percentile_mass_mask(jnp.asarray(arr), pct))
        got = TE._percentile_mass_mask(torch.from_numpy(arr), pct).numpy()
        assert got.shape == arr.shape and got.dtype == np.float32
        diff = got != want
        assert diff.sum() <= 2, (pct, int(diff.sum()))
        if diff.any():
            flat = np.sort(arr.reshape(-1).astype(np.float64))
            csum = np.cumsum(flat)
            thresh = flat[int(np.argmax(csum >= pct / 100.0 * csum[-1]))]
            window = np.abs(arr[diff] - thresh) / max(thresh, 1e-12)
            assert window.max() < 1e-4, (pct, window.max())
    stack = torch.from_numpy(np.stack([cases[0], 2 * cases[0], 0 * cases[0]]))
    batched = TE._percentile_mass_mask(stack, pct, batch_dims=1)
    for b in range(3):
        np.testing.assert_array_equal(
            batched[b].numpy(),
            TE._percentile_mass_mask(stack[b], pct).numpy())


def _select_cases():
    rng = np.random.RandomState(4)
    n = 12
    P = rng.rand(n, 1, 6, 6).astype(np.float32)
    P[[3, 7]] = 0.0  # invalid: map max 0
    maxes = P.max(axis=(1, 2, 3))
    scores = rng.rand(n).astype(np.float32)
    tied = scores.copy()
    tied[[0, 2, 5, 9]] = tied[4]  # tied scores: stable order decides
    flat = np.full(n, 0.3, np.float32)  # equal scores: all-ones fallback
    return {"random": (P, maxes, scores, 4),
            "tied": (P, maxes, tied, 4),
            "fewer_than_topk": (P, maxes, scores, 32),
            "all_ones_fallback": (P, maxes, flat, 5),
            "none_valid": (0 * P, 0 * maxes, scores, 4)}


@pytest.mark.parametrize("do_max", [False, True])
@pytest.mark.parametrize("case", sorted(_select_cases()))
def test_select_merge_matches_jax(case, do_max):
    """Selection mask equal; merged map rtol 1e-6 / atol 1e-7 (float32
    arithmetic in the same order)."""
    P, maxes, scores, topk = _select_cases()[case]
    jm, js = JE._wsebp_select_merge(jnp.asarray(P), jnp.asarray(maxes),
                                    jnp.asarray(scores), topk, do_max, 1e-16)
    tm, ts = TE._wsebp_select_merge(torch.from_numpy(P),
                                    torch.from_numpy(maxes),
                                    torch.from_numpy(scores), topk, do_max,
                                    1e-16)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-6,
                               atol=1e-7)
    if case == "fewer_than_topk":
        assert ts.sum() == (maxes > 0).sum() - (maxes[1] > 0)
    if case == "all_ones_fallback":
        assert ts.sum() == topk and tm.numpy().max() > 0


def test_argmax_ties_go_to_the_first_index():
    """The ranking pass takes argmax of (a >= 0) * (-b), a plane full of
    exact zeros: torch.argmax, like jnp.argmax, returns the first index of
    the maximum, on an all-zero plane and on a repeated maximum."""
    planes = np.zeros((3, 50), np.float32)
    planes[1, [7, 19, 40]] = 2.5
    planes[2] = -1.0
    planes[2, [11, 12]] = -0.0
    got = torch.argmax(torch.from_numpy(planes), dim=1).numpy()
    want = np.asarray(jnp.argmax(jnp.asarray(planes), axis=1))
    np.testing.assert_array_equal(got, [0, 7, 11])
    np.testing.assert_array_equal(got, want)
    # as the ranking pass forms it, from a and b
    a = np.zeros((2, 40), np.float32)
    b = np.zeros((2, 40), np.float32)
    b[1, [5, 30]] = -3.0
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    gated = ((ta >= 0) * (-tb)).argmax(dim=1).numpy()
    jgated = np.asarray(jnp.argmax((jnp.asarray(a) >= 0)
                                   * (-jnp.asarray(b)), axis=1))
    np.testing.assert_array_equal(gated, [0, 5])
    np.testing.assert_array_equal(gated, jgated)
