"""xfr_torch.ops and xfr_torch.graph against the JAX package, in float64.

Every op's forward and its EBP vjp (op_vjp) are run on the same seeded
inputs through both packages.  Tolerance: 1e-10 relative / 1e-12
absolute — both run float64 on the CPU, and only the summation order of
the convolutions and products differs.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from xfr_tpu import graph as JG
from xfr_tpu import ops as JO
from xfr_tpu.models import resnet101 as JR

from xfr_torch import graph as TG
from xfr_torch import ops as TO
from xfr_torch.models import resnet101 as TR
from tests import torch_fixtures  # noqa: F401  (sets torch threads)

RTOL, ATOL = 1e-10, 1e-12


def _params(rng, shapes):
    return {k: rng.randn(*s) for k, s in shapes.items()}


# (op, param shapes, input shapes, attrs)
OP_CASES = {
    "conv2d": ("conv2d", {"w": (6, 3, 7, 7), "b": (6,)}, [(2, 3, 17, 15)],
               dict(stride=(2, 2), padding=(3, 3))),
    "conv2d_nobias_dilated": ("conv2d", {"w": (4, 3, 3, 3)},
                              [(1, 3, 12, 12)],
                              dict(stride=(1, 1), padding=(2, 2),
                                   dilation=(2, 2))),
    "linear": ("linear", {"w": (5, 7), "b": (5,)}, [(3, 7)], {}),
    "linear_nobias": ("linear", {"w": (5, 7)}, [(3, 7)], {}),
    "batchnorm2d": ("batchnorm2d", {"gamma": (4,), "beta": (4,),
                                    "mean": (4,), "var": (4,)},
                    [(2, 4, 5, 5)], dict(eps=1e-5)),
    "relu": ("relu", {}, [(2, 3, 4, 4)], {}),
    "maxpool2d_k3s2p1": ("maxpool2d", {}, [(2, 3, 9, 8)],
                         dict(kernel=(3, 3), stride=(2, 2), padding=(1, 1),
                              ceil_mode=False)),
    "maxpool2d_ceil": ("maxpool2d", {}, [(1, 2, 7, 10)],
                       dict(kernel=(2, 2), stride=(2, 2), padding=(0, 0),
                            ceil_mode=True)),
    "avgpool2d_k2": ("avgpool2d", {}, [(2, 3, 8, 8)],
                     dict(kernel=(2, 2), stride=(2, 2), padding=(0, 0),
                          ceil_mode=False)),
    "avgpool2d_count_include_pad": ("avgpool2d", {}, [(1, 2, 9, 7)],
                                    dict(kernel=(3, 3), stride=(2, 2),
                                         padding=(1, 1), ceil_mode=True)),
    "add": ("add", {}, [(2, 3, 4, 4), (2, 3, 4, 4)], {}),
    "multiply_const": ("multiply_const", {}, [(2, 6)], dict(c=50.0)),
    "concat_zero_channels": ("concat_zero_channels", {}, [(2, 3, 4, 4)],
                             dict(mult=3)),
    "flatten": ("flatten", {}, [(2, 3, 2, 2)], {}),
    "l2normalize": ("l2normalize", {}, [(3, 8)], dict(axis=1)),
}


@pytest.mark.parametrize("case", sorted(OP_CASES))
def test_op_forward_and_vjp_match_jax(case):
    op, pshapes, xshapes, attrs = OP_CASES[case]
    rng = np.random.RandomState(sorted(OP_CASES).index(case))
    params = _params(rng, pshapes)
    if op == "batchnorm2d":
        params["var"] = np.abs(params["var"]) + 0.5
    xs = [rng.randn(*s) for s in xshapes]
    if op == "relu":
        xs[0].reshape(-1)[::5] = 0.0  # exact ties at 0

    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    jx = tuple(jnp.asarray(x) for x in xs)
    tx = tuple(torch.from_numpy(x) for x in xs)

    jy = np.asarray(JO.apply_op(op, jp, jx, attrs))
    ty = TO.apply_op(op, tp, tx, attrs).numpy()
    np.testing.assert_allclose(ty, jy, rtol=RTOL, atol=ATOL)

    ct = rng.randn(*jy.shape)
    jg = JO.op_vjp(op, jp, jx, attrs, jnp.asarray(ct))
    tg = TO.op_vjp(op, tp, tx, attrs, torch.from_numpy(ct))
    assert len(jg) == len(tg)
    for a, b in zip(jg, tg):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=RTOL,
                                   atol=ATOL)


def test_relu_vjp_tie_is_half():
    """jax.vjp(jnp.maximum(x, 0)) gives 0.5 at x == 0; so must the port."""
    x = torch.tensor([[-1.0, 0.0, 2.0]], dtype=torch.float64)
    (g,) = TO.op_vjp("relu", {}, (x,), {}, torch.ones_like(x))
    np.testing.assert_array_equal(g.numpy(), [[0.0, 0.5, 1.0]])
    (jg,) = JO.op_vjp("relu", {}, (jnp.asarray(x.numpy()),), {},
                      jnp.ones((1, 3)))
    np.testing.assert_array_equal(g.numpy(), np.asarray(jg))


@pytest.mark.parametrize("padding,ceil_mode", [((0, 0), False),
                                               ((1, 1), False),
                                               ((1, 1), True)])
def test_maxpool_tie_routes_to_first_max(padding, ceil_mode):
    """An all-zero (post-ReLU) input: every window is a tie, and both
    packages route its gradient to the window's first element."""
    x = np.zeros((1, 2, 7, 7))
    attrs = dict(kernel=(3, 3), stride=(2, 2), padding=padding,
                 ceil_mode=ceil_mode)
    y = TO.apply_op("maxpool2d", {}, (torch.from_numpy(x),), attrs)
    ct = np.arange(1, y.numel() + 1, dtype=np.float64).reshape(y.shape)
    (tg,) = TO.op_vjp("maxpool2d", {}, (torch.from_numpy(x),), attrs,
                      torch.from_numpy(ct))
    (jg,) = JO.op_vjp("maxpool2d", {}, (jnp.asarray(x),), attrs,
                      jnp.asarray(ct))
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    # first max of each window: its top-left in-bounds element
    p = padding[0]
    expect = np.zeros_like(x)
    for i in range(y.shape[2]):
        for j in range(y.shape[3]):
            r, c = max(0, 2 * i - p), max(0, 2 * j - p)
            expect[0, :, r, c] += ct[0, :, i, j]
    np.testing.assert_array_equal(tg.numpy(), expect)


def test_pool_out_size_matches_jax():
    for size in range(5, 16):
        for k in (1, 2, 3, 7):
            for s in (1, 2, 3):
                for p in (0, 1, 3):
                    if k > size + 2 * p or p > k // 2 + 1:
                        continue
                    for ceil in (False, True):
                        assert TO._pool_out_size(size, k, s, p, ceil) == \
                            JO._pool_out_size(size, k, s, p, ceil)
    assert TO._pair(3) == JO._pair(3) == (3, 3)
    assert TO._pair([1, 2]) == JO._pair([1, 2]) == (1, 2)


@pytest.mark.parametrize("with_bias", [False, True])
def test_positive_params_match_jax(with_bias):
    rng = np.random.RandomState(1)
    for op, shapes in (("conv2d", {"w": (3, 2, 1, 1), "b": (3,)}),
                       ("linear", {"w": (3, 2), "b": (3,)}),
                       ("batchnorm2d", {"gamma": (3,), "beta": (3,),
                                        "mean": (3,), "var": (3,)})):
        p = _params(rng, shapes)
        jp = JO.positive_params(op, {k: jnp.asarray(v) for k, v in p.items()},
                                with_bias)
        tp = TO.positive_params(op, {k: torch.from_numpy(v)
                                     for k, v in p.items()}, with_bias)
        assert sorted(jp) == sorted(tp)
        for k in jp:
            np.testing.assert_array_equal(tp[k].numpy(), np.asarray(jp[k]))


def _fields(graph):
    return ([dataclasses.astuple(n) for n in graph.nodes],
            [dataclasses.astuple(e) for e in graph.events],
            graph.event_node, graph.n_tensors, graph.input_id,
            graph.output_id)


def test_resnet101_events_match_jax():
    jg, jshapes, jenc = JR.build_resnet101(num_classes=16,
                                           layers=(1, 1, 1, 1))
    tg, tshapes, tenc = TR.build_resnet101(num_classes=16,
                                           layers=(1, 1, 1, 1))
    assert (len(tg.nodes), tg.n_events) == (58, 60)
    assert _fields(tg) == _fields(jg)
    assert tshapes == jshapes and tenc == jenc
    assert tg.event_names() == jg.event_names()
    for e, je in zip(tg.events, jg.events):
        assert (e.is_affine, e.is_poolrelu, e.is_special) == \
            (je.is_affine, je.is_poolrelu, je.is_special)


def test_resnet101_full_depth_schedule_matches_jax():
    jg, _, _ = JR.build_resnet101()
    tg, _, _ = TR.build_resnet101()
    assert (len(tg.nodes), tg.n_events) == (348, 379)
    assert _fields(tg) == _fields(jg)


def test_toy_graph_and_builder_helpers_match_jax():
    from tests.fixtures import make_toy_wbnet
    from tests.torch_fixtures import toy_graph

    g, enc, out = toy_graph()
    tg = g.finalize(out)
    jg = make_toy_wbnet().net.graph
    assert _fields(tg) == _fields(jg)
    # dilation attrs, unique pnames and the unhooked '+'
    tb, jb = TG.GraphBuilder("t"), JG.GraphBuilder("t")
    for b in (tb, jb):
        x = b.conv2d(0, 3, 4, 3, dilation=2, name="c")
        y = b.conv2d(x, 4, 4, 1, name="c")
        b.funcadd(x, y)
    assert [dataclasses.astuple(n) for n in tb.nodes] == \
        [dataclasses.astuple(n) for n in jb.nodes]
    assert tb.param_shapes == jb.param_shapes
