"""The port's other face matchers against the JAX package: the six ops of
LightCNN and SENet, the graphs of LightCNN-29 v2, VGGFace2
ResNet-50-128 and SENet-50-256 and VGG-16, their forwards, EBP on the
oracle mfm net, the 4-map mix on reduced-depth LightCNN, the
``ebp_lightcnn`` and ``ebp_resnet50_128`` goldens, the factory's new
branches, the checkpoint round trip and the three preprocessors.

Each test states its tolerance.  Float64 walks and forwards of the two
packages differ only in summation order: rtol 1e-10.
"""

import dataclasses
import functools
import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from xfr_tpu import ops as JO
from xfr_tpu.ebp import interpreter as JI
from xfr_tpu.ebp.engine import Whitebox as JWhitebox
from xfr_tpu.ebp.engine import WhiteboxNetwork as JNet
from xfr_tpu.models import common as JC
from xfr_tpu.models import lightcnn as JL
from xfr_tpu.models import vggface as JV
from xfr_tpu.models import vggface2 as JV2
from tests.oracles import nets as N
from tests.test_torch_ops import _fields
from tests.torch_fixtures import jax_params_np, twin_whitebox

from xfr_torch import ops as TO
from xfr_torch.ebp import interpreter as TI
from xfr_torch.ebp.engine import Whitebox, WhiteboxNetwork
from xfr_torch.graph import GraphBuilder
from xfr_torch.models import checkpoint as TCK
from xfr_torch.models import common as TC
from xfr_torch.models import lightcnn as TL
from xfr_torch.models import vggface as TV
from xfr_torch.models import vggface2 as TV2
from xfr_torch.models.convert import params_from_jax

RTOL, ATOL = 1e-10, 1e-12

# ---------------------------------------------------------------------------
# The six ops
# ---------------------------------------------------------------------------

# (op, input shapes)
NEW_OPS = {
    "global_avgpool2d": ("global_avgpool2d", [(2, 4, 3, 5)]),
    "mul_gate_first": ("mul", [(2, 4, 1, 1), (2, 4, 3, 3)]),
    "mul_gate_second": ("mul", [(2, 4, 3, 3), (2, 4, 1, 1)]),
    "split_identity": ("split_identity", [(2, 6, 3, 3)]),
    "pair_max_conv": ("pair_max", [(2, 6, 3, 3)]),
    "pair_max_linear": ("pair_max", [(3, 8)]),
    "dropout_eval": ("dropout_eval", [(3, 5)]),
    "sigmoid": ("sigmoid", [(2, 3, 4, 4)]),
}


@pytest.mark.parametrize("case", sorted(NEW_OPS))
def test_new_op_forward_vjp_and_rows_match_jax(case):
    """Forward and vjp against JAX in float64 (rtol 1e-10); row r of
    op_vjp_rows equals JAX's vjp of cotangent row r (rtol 1e-10).  The
    pair_max inputs carry exact ties."""
    op, xshapes = NEW_OPS[case]
    rng = np.random.RandomState(sorted(NEW_OPS).index(case))
    xs = [rng.randn(*s) for s in xshapes]
    if op == "pair_max":
        c = xs[0].shape[1] // 2
        xs[0][:, c:][:, ::2] = xs[0][:, :c][:, ::2]
    jx = tuple(jnp.asarray(x) for x in xs)
    tx = tuple(torch.from_numpy(x) for x in xs)
    jy = np.asarray(JO.apply_op(op, {}, jx, {}))
    np.testing.assert_allclose(TO.apply_op(op, {}, tx, {}).numpy(), jy,
                               rtol=RTOL, atol=ATOL)
    g = rng.randn(3, *jy.shape)
    rows = TO.op_vjp_rows(op, {}, tx, {}, torch.from_numpy(g))
    assert len(rows) == len(xs)
    for r in range(3):
        want = JO.op_vjp(op, {}, jx, {}, jnp.asarray(g[r]))
        single = TO.op_vjp(op, {}, tx, {}, torch.from_numpy(g[r]))
        for a, b, w in zip(rows, single, want):
            np.testing.assert_allclose(a[r].numpy(), np.asarray(w),
                                       rtol=RTOL, atol=ATOL)
            np.testing.assert_allclose(b.numpy(), np.asarray(w), rtol=RTOL,
                                       atol=ATOL)


def test_pair_max_tie_is_half():
    """A tie of the two halves sends half the gradient to each, as
    jnp.maximum's vjp does (a ``where(a > b)`` would send it all to one);
    exact values."""
    x = torch.tensor([[1.0, 2.0, -3.0, 1.0, 5.0, -3.0]], dtype=torch.float64)
    (g,) = TO.op_vjp_rows("pair_max", {}, (x,), {},
                          torch.ones((2, 1, 3), dtype=torch.float64))
    want = [[[0.5, 0.0, 0.5, 0.5, 1.0, 0.5]]] * 2
    np.testing.assert_array_equal(g.numpy(), want)
    (jg,) = JO.op_vjp("pair_max", {}, (jnp.asarray(x.numpy()),), {},
                      jnp.ones((1, 3)))
    np.testing.assert_array_equal(g[0].numpy(), np.asarray(jg))


def test_new_ops_have_row_rules():
    """Only l2normalize (a head op) goes through the autograd fallback,
    which copies the capture once per row."""
    assert set(TO.OPS) == set(JO.OPS)
    assert set(TO.OPS) - set(TO._ROW_VJPS) == {"l2normalize"}


# ---------------------------------------------------------------------------
# Graphs: event schedules and forwards
# ---------------------------------------------------------------------------

BUILDERS = {
    "lightcnn_full": (JL.build_lightcnn29v2, TL.build_lightcnn29v2,
                      dict(num_classes=80013), (113, 88)),
    "lightcnn_reduced": (JL.build_lightcnn29v2, TL.build_lightcnn29v2,
                         dict(num_classes=9, layers=(1, 1, 1, 1)),
                         (71, 52)),
    "resnet50_128": (JV2.build_resnet50_128, TV2.build_resnet50_128, {},
                     (176, 158)),
    "resnet50_128_5class": (JV2.build_resnet50_128, TV2.build_resnet50_128,
                            dict(num_classes=5), (176, 158)),
    "senet50_256": (JV2.build_senet50_256, TV2.build_senet50_256, {},
                    (272, 238)),
    "vgg16_full": (JV.build_vgg16, TV.build_vgg16, {}, (40, 38)),
    "vgg16_reduced": (JV.build_vgg16, TV.build_vgg16,
                      dict(num_classes=11, cfg=((1, 8), (1, 8), (2, 16),
                                                (2, 16), (2, 16)),
                           input_hw=64, fc_dim=32), (30, 28)),
}


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_builder_schedule_matches_jax(name):
    """Nodes, events (field by field), event nodes, parameter shapes and
    the encode tensor equal to the JAX builder's."""
    jbuild, tbuild, kw, (n_nodes, n_events) = BUILDERS[name]
    jg, jshapes, jenc = jbuild(**kw)
    tg, tshapes, tenc = tbuild(**kw)
    assert (len(tg.nodes), tg.n_events) == (n_nodes, n_events)
    assert _fields(tg) == _fields(jg)
    assert tshapes == jshapes and tenc == jenc
    assert tg.event_names() == jg.event_names()
    for e, je in zip(tg.events, jg.events):
        assert (e.is_affine, e.is_poolrelu, e.is_special) == \
            (je.is_affine, je.is_poolrelu, je.is_special)


def _forward_pair(name, shape, seed):
    jbuild, tbuild, kw, _ = FORWARDS[name]
    jg, shapes, jenc = jbuild(**kw)
    tg, _, tenc = tbuild(**kw)
    params = TC.init_params(shapes, seed=seed, dtype=torch.float64)
    jp = {k: {kk: jnp.asarray(vv.numpy()) for kk, vv in v.items()}
          for k, v in params.items()}
    x = np.random.RandomState(seed).rand(*shape)
    jv = JI.forward_clean(jg, jp, jnp.asarray(x))
    tv = TI.forward_clean(tg, params, torch.from_numpy(x))
    return (jv[jg.output_id], jv[jenc]), (tv[tg.output_id], tv[tenc])


FORWARDS = {
    "lightcnn_fulldepth": (JL.build_lightcnn29v2, TL.build_lightcnn29v2,
                           dict(num_classes=13, layers=(1, 2, 3, 4)),
                           (1, 1, 128, 128)),
    "resnet50_128": (JV2.build_resnet50_128, TV2.build_resnet50_128, {},
                     (1, 3, 224, 224)),
    "senet50_256": (JV2.build_senet50_256, TV2.build_senet50_256, {},
                    (1, 3, 224, 224)),
    "vgg16_reduced": BUILDERS["vgg16_reduced"][:3] + ((2, 3, 64, 64),),
}


@pytest.mark.parametrize("name", sorted(FORWARDS))
def test_forward_matches_jax(name):
    """Logits and embedding against the JAX forward, float64, the numpy
    init of seed 5 on both sides: rtol 1e-10 (atol 1e-12 of the largest
    entry)."""
    (jy, je), (ty, te) = _forward_pair(name, FORWARDS[name][3], 5)
    for t, j in ((ty, jy), (te, je)):
        j = np.asarray(j)
        assert np.isfinite(j).all() and np.abs(j).max() > 0
        np.testing.assert_allclose(t.numpy(), j, rtol=RTOL,
                                   atol=ATOL * np.abs(j).max())


def test_senet_ebp_raises_on_sigmoid():
    graph, shapes, _ = TV2.build_senet50_256()
    params = TC.init_params(shapes, seed=0)
    with pytest.raises(ValueError, match="special case"):
        TI.ebp(graph, params, torch.zeros((1, 3, 224, 224)),
               torch.zeros((1, 2)), subtree_mode="norelu")


# ---------------------------------------------------------------------------
# EBP on the oracle mfm net, built with the port's builders
# ---------------------------------------------------------------------------


def mfm_graph():
    """tests/oracles/nets.make_mfm's graph, built by the port."""
    g = GraphBuilder("mfm")
    x = g.mfm_conv(0, 1, 4, 3, padding=1, name="conv1")
    x = g.funcadd(g.maxpool2d(x, 2), g.avgpool2d(x, 2))
    x = g.mfm_conv(x, 4, 6, 3, padding=1, name="conv2")
    x = g.funcadd(g.maxpool2d(x, 2), g.avgpool2d(x, 2))
    x = g.flatten(x)
    x = g.mfm_linear(x, 6 * 4 * 4, 8, name="fc")
    x = g.dropout_eval(x)
    x = g.linear(x, 8, 5, bias=False, name="fc2")
    return g.finalize(x)


@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("mode", ["affineonly", "affineonly_with_prior",
                                  "norelu", "all"])
def test_mfm_ebp_matches_jax(mode, with_bias):
    """Every event's MWP of one walk on the mfm net (two mfm convs, the
    max+avg pool pairs, the mfm linear, dropout), float64, rtol 1e-10
    (atol 1e-12 of the event's max), the input's pair_max ties included."""
    _, jgraph, jparams, _ = N.make_mfm(0)
    tgraph = mfm_graph()
    assert _fields(tgraph) == _fields(jgraph)
    params = params_from_jax(jax_params_np(jparams), device="cpu")
    x = torch.rand((1, 1, 16, 16), generator=torch.Generator().manual_seed(4),
                   dtype=torch.float64)
    x[..., ::3] = 0.0  # zero plane rows: conv1 ties across its halves
    Pn = torch.zeros((1, 5), dtype=torch.float64)
    Pn[0, 2] = 1.0
    want = JI.ebp(jgraph, jparams, jnp.asarray(x.numpy()),
                  jnp.asarray(Pn.numpy()), subtree_mode=mode, eps=1e-12,
                  with_bias=with_bias)
    got = TI.ebp(tgraph, params, x, Pn, subtree_mode=mode, eps=1e-12,
                 with_bias=with_bias)
    assert sorted(got) == sorted(want) == list(range(tgraph.n_events))
    for k in want:
        w = np.asarray(want[k])
        np.testing.assert_allclose(got[k].numpy(), w, rtol=RTOL,
                                   atol=ATOL * max(np.abs(w).max(), 1e-30),
                                   err_msg=f"event {k}")


@pytest.mark.parametrize("mode", ["affineonly", "affineonly_with_prior",
                                  "norelu", "all"])
def test_mfm_weighted_subtree_matches_jax(mode):
    """The weighted-subtree machinery on the mfm net in each subtree mode,
    float64, a unit-norm triplet classifier in place of fc2: the ranking
    pass (equal argmaxes, scores and injection values at rtol 1e-10), the
    bucketed, cascaded candidate sweep (maps and maxima at rtol 1e-6: both
    cast each map to float32 before its channel sum), and the per-probe
    weighted_subtree_ebp with its subtree maps (the same subtrees, scores
    at rtol 1e-6, maps within 1e-6 of their max), or the same refusal
    where no candidate leaves a map."""
    _, jgraph, jparams, _ = N.make_mfm(1)
    jwb = JWhitebox(JNet(jgraph, jparams, encode_tensor=jgraph.output_id,
                         classifier_pname="fc2", num_classes=5),
                    ebp_version=6, ebp_subtree_mode=mode, eps=1e-12)
    twb = twin_whitebox(jwb, graph=mfm_graph())
    # the JAX package's float32 one-hot is refused by its float64 walk
    jwb._onehot = lambda k: jnp.asarray(np.eye(2)[k:k + 1])
    rng = np.random.RandomState(6)
    em, en = (v / np.linalg.norm(v) for v in rng.rand(2, 8))
    for wb in (jwb, twb):
        wb.net.set_triplet_classifier(em, en)
    x = rng.rand(1, 1, 16, 16)
    js, ji, jv = jwb._wsebp_grad_fn()(jwb.net.params, jnp.asarray(x),
                                      jwb._onehot(0), gating=True)
    ts, ti, tv = twb._wsebp_grad_fn()(twb.net.params, torch.from_numpy(x),
                                      twb._onehot(0), True)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    for a, b in ((ts, js), (tv, jv)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-10,
                                   atol=1e-300)
    jP, jm = jwb._wsebp_sweep_fn(n_buckets=3)(
        jwb.net.params, jnp.asarray(x), ji.astype(jnp.int32), jv)
    tP, tm = twb._wsebp_sweep_fn(n_buckets=3)(
        twb.net.params, torch.from_numpy(x), ti.to(torch.int32), tv)
    np.testing.assert_allclose(tP.numpy(), np.asarray(jP), rtol=1e-6,
                               atol=0)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-6,
                               atol=0)
    kw = dict(topk=3, subtree_mode=mode, return_subtree_maps=True)
    try:
        want = jwb.weighted_subtree_ebp(jnp.asarray(x), 0, 1, **kw)
    except RuntimeError:
        with pytest.raises(RuntimeError, match="valid subtrees"):
            twb.weighted_subtree_ebp(x, 0, 1, **kw)
        return
    got = twb.weighted_subtree_ebp(x, 0, 1, **kw)
    assert got[3] == want[3] and len(got[1]) == len(want[1])
    np.testing.assert_allclose(got[2], want[2], rtol=1e-6)
    for a, b in zip([got[0]] + got[1], [want[0]] + want[1]):
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=1e-6 * np.abs(b).max())


# ---------------------------------------------------------------------------
# The 4-map mix on reduced-depth LightCNN
# ---------------------------------------------------------------------------


def _reduced_lightcnn_pair(nc, dtype=np.float32):
    """LightCNN-29 v2 at full widths with one block per stage: the JAX
    Whitebox over the numpy init of seed 0 and the port's over the same
    weights, both in the net's affineonly_with_prior mode."""
    graph, shapes, enc = JL.build_lightcnn29v2(num_classes=nc,
                                               layers=(1, 1, 1, 1))
    params = JC.init_params(shapes, seed=0, dtype=dtype)
    jwb = JWhitebox(JNet(graph, params, encode_tensor=enc,
                         classifier_pname="fc2", num_classes=nc,
                         preprocess=JL.preprocess_lightcnn),
                    ebp_version=6, ebp_subtree_mode="affineonly_with_prior")
    tgraph, _, tenc = TL.build_lightcnn29v2(num_classes=nc,
                                            layers=(1, 1, 1, 1))
    twb = Whitebox(WhiteboxNetwork(
        tgraph, params_from_jax(jax_params_np(params, dtype), device="cpu"),
        encode_tensor=tenc, classifier_pname="fc2", num_classes=nc,
        preprocess=functools.partial(TL.preprocess_lightcnn, device="cpu")),
        ebp_version=6, ebp_subtree_mode="affineonly_with_prior")
    rng = np.random.RandomState(0)
    probes = rng.rand(2, 1, 128, 128).astype(np.float32)
    e = np.asarray(jwb.encode(jnp.asarray(rng.rand(2, 1, 128, 128), dtype)))
    em, en = e[0] / np.linalg.norm(e[0]), e[1] / np.linalg.norm(e[1])
    return jwb, twb, probes, em, en, rng


def test_four_map_mix_reduced_lightcnn_matches_jax():
    """bench.py's mix on reduced LightCNN (one block per stage), 16
    classes, probes of 1x128x128, float32 on both sides: mean-EBP under an
    all-ones cotangent and the em/2500 triplet contrastive pair on B=2,
    weighted-subtree top-32 in the net's affineonly_with_prior mode on the
    first probe (the second's float32 ranking is ill-conditioned at these
    random weights: see the next test).

    Weighted-subtree map within 1e-4 of its maximum, equal subtree
    selections, scores at rtol 5e-5, the contrastive maps at correlation
    >= 0.999 (the ResNet test's limits).  Mean-EBP maps within 5e-4 of
    their maximum: measured 1.3e-4, where the ResNet mix reads below 1e-4.
    The probes through convert_from_numpy at rtol 1e-6, their embeddings
    at rtol 1e-4."""
    nc, B = 16, 2
    jwb, twb, probes, em, en, rng = _reduced_lightcnn_pair(nc)

    def mix(wb, x, Pn):
        wb.net.reset_classifier()
        pooled, _ = wb._ebp_pooled_fn()(wb.net.params, x, Pn)
        mean = [wb._mwp_to_saliency(np.asarray(pooled)[i]) for i in range(B)]
        wb.set_triplet_classifier_batch(np.tile(em / 2500.0, (B, 1)),
                                        np.tile(en / 2500.0, (B, 1)))
        contr, trunc = wb.launch_contrastive_ebp_batch_both(x, 20)()
        wb.set_triplet_classifier_batch(em[None], en[None])
        ws = wb.launch_weighted_subtree_ebp_batch(
            x[:1], topk=32, subtree_mode="affineonly_with_prior")()
        wb.net.reset_classifier()
        return mean, contr, trunc, ws

    ones = np.ones((B, nc), np.float32)
    jm, jc, jt, jws = mix(jwb, jnp.asarray(probes), jnp.asarray(ones))
    tm, tc, tt, tws = mix(twb, torch.from_numpy(probes),
                          torch.from_numpy(ones))
    for a, b in zip(tm, jm):
        assert a.shape == (128, 128)
        np.testing.assert_allclose(a, b, atol=5e-4 * b.max(), rtol=0)
    for a, b in zip(tc + tt, jc + jt):
        assert a.shape == (128, 128)
        assert np.corrcoef(a.ravel(), b.ravel())[0, 1] >= 0.999
    (s_t, _, sc_t, k_t), (s_j, _, sc_j, k_j) = tws[0], jws[0]
    # in affineonly_with_prior 18 of the 51 candidates leave a map
    assert k_t == k_j and len(k_t) >= 16
    np.testing.assert_allclose(sc_t, sc_j, rtol=5e-5)
    np.testing.assert_allclose(s_t, s_j, atol=1e-4 * s_j.max(), rtol=0)

    faces = [(rng.rand(150, 140, 3) * 255).astype(np.uint8)
             for _ in range(2)]
    x_t = twb.convert_from_numpy(faces[0])
    x_j = np.asarray(jwb.convert_from_numpy(faces[0]))
    assert tuple(x_t.shape) == x_j.shape == (1, 1, 128, 128)
    np.testing.assert_allclose(x_t.numpy(), x_j, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(twb.embeddings(faces), jwb.embeddings(faces),
                               rtol=1e-4, atol=1e-5)


def test_reduced_lightcnn_ranking_pass_matches_jax_float64():
    """The batched ranking pass of the weighted-subtree path on reduced
    LightCNN under the interleaved [2B, D] classifier, B=2, float64:
    equal argmaxes, scores and injection values at rtol 1e-10.  In float32
    the second probe's scores differ between the two frameworks by up to
    17% (its gated gradients sit near the gate's zero, and the MWPs reach
    1e10 at random weights) while in float64 they agree to 3e-14: the
    float32 mix test compares the first probe only."""
    jwb, twb, probes, em, en, _ = _reduced_lightcnn_pair(16, np.float64)
    w = np.stack([np.tile(em, (2, 1)), np.tile(en, (2, 1))],
                 1).reshape(4, -1)
    jwb.net.params = dict(jwb.net.params, fc2={"w": jnp.asarray(w)})
    twb.net.params = dict(twb.net.params, fc2={"w": torch.from_numpy(w)})
    x = probes.astype(np.float64)
    js, ji, jv = jwb._wsebp_grad_batch_fn()(jwb.net.params, jnp.asarray(x),
                                            gating=True)
    ts, ti, tv = twb._wsebp_grad_batch_fn()(twb.net.params,
                                            torch.from_numpy(x), True)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-10,
                               atol=1e-300)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-10,
                               atol=1e-300)


# ---------------------------------------------------------------------------
# Goldens: ebp_lightcnn and ebp_resnet50_128 (full depth)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("net_name,golden,subtree_mode", [
    ("lightcnn", "ebp_lightcnn", "affineonly"),
    ("vggface2_resnet50", "ebp_resnet50_128", None)])
def test_other_net_goldens(net_name, golden, subtree_mode):
    """The two entries of demo/whitebox_goldens.npz from the port's nets
    at full depth, float32, with the weights of the JAX package's
    create_wbnet carried across and the port's own preprocess of the demo
    face; class 0's one-hot.  Held at test_demo_goldens.py's tolerance
    (rtol 1e-3, atol 1e-5 of the golden's max)."""
    from tests.test_demo_goldens import GOLDEN_PATH, _demo_face_arr
    from xfr_tpu.models import create_wbnet as jax_create_wbnet
    from xfr_torch.models import factory

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        kw = {} if subtree_mode is None else dict(
            ebp_subtree_mode=subtree_mode)
        jwb = jax_create_wbnet(net_name, **kw)
        twb = factory.create_wbnet(net_name, device="cpu", **kw)
    twb.net.params = params_from_jax(
        jax_params_np(jwb.net.params, np.float32), device="cpu")
    twb.net._orig_classifier = twb.net.params[twb.net.classifier_pname]
    face = _demo_face_arr()
    x = twb.net.preprocess(face)
    np.testing.assert_array_equal(x.numpy(),
                                  np.asarray(jwb.net.preprocess(face)))
    P = np.eye(twb.net.num_classes(), dtype=np.float32)[:1]
    m = twb.ebp(x, P)
    g = np.load(GOLDEN_PATH)[golden]
    assert m.shape == g.shape
    np.testing.assert_allclose(m, g, rtol=1e-3,
                               atol=1e-5 * max(g.max(), 1e-12))


# ---------------------------------------------------------------------------
# The factory and the checkpoint
# ---------------------------------------------------------------------------


def test_factory_branches():
    """Constants, default subtree modes, classifiers and event counts of
    the new branches against the JAX factory's; an explicit subtree mode
    wins; the ebp_version warning of vggface2_resnet50; unknown nets and
    the ebp_version floor refused."""
    from xfr_tpu.models import factory as JF
    from xfr_torch.models import factory as TF

    assert TF.WEIGHT_FILES == JF.WEIGHT_FILES
    assert (TL.LIGHTCNN_MATCH_THRESHOLD, TL.LIGHTCNN_PLATTS_SCALING) == \
        (JL.LIGHTCNN_MATCH_THRESHOLD, JL.LIGHTCNN_PLATTS_SCALING)
    assert (TV2.VGGFACE2_MATCH_THRESHOLD, TV2.VGGFACE2_PLATTS_SCALING) == \
        (JV2.VGGFACE2_MATCH_THRESHOLD, JV2.VGGFACE2_PLATTS_SCALING)
    np.testing.assert_array_equal(TV2.MEAN_BGRISH, JV2.MEAN_BGRISH)
    np.testing.assert_array_equal(TV.MEAN_BGR, JV.MEAN_BGR)
    np.testing.assert_array_equal(TL._GRAY, JL._GRAY)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        wbs = {n: TF.create_wbnet(n, device="cpu") for n in
               ("lightcnn", "vggface2_resnet50", "senet50_256")}
        with pytest.warns(UserWarning, match="ebp_version 5 is ignored"):
            TF.create_wbnet("vggface2_resnet50", device="cpu", ebp_version=5)
        lw = TF.create_wbnet("lightcnn", device="cpu", ebp_version=5,
                             ebp_subtree_mode="norelu")
    assert lw.ebp_subtree_mode() == "norelu" and lw.convert_saliency_uint8
    want = {"lightcnn": ("affineonly_with_prior", "fc2", 80013, 256, 88,
                         JL.LIGHTCNN_MATCH_THRESHOLD),
            "vggface2_resnet50": ("norelu", "fc1", 2, 128, 158,
                                  JV2.VGGFACE2_MATCH_THRESHOLD),
            "senet50_256": ("norelu", "fc1", 2, 256, 238, None)}
    for n, wb in wbs.items():
        net = wb.net
        assert (wb.ebp_subtree_mode(), net.classifier_pname,
                net.num_classes(), net.embed_dim, net.graph.n_events,
                wb.match_threshold) == want[n], n
        assert net.device.type == "cpu"
    assert wbs["lightcnn"].platts_scaling == JL.LIGHTCNN_PLATTS_SCALING
    assert tuple(wbs["vggface2_resnet50"].net.params["fc1"]["w"].shape) == \
        (2, 128)
    with pytest.raises(NotImplementedError, match="does not implement"):
        TF.create_wbnet("vgg16", device="cpu")
    with pytest.raises(DeprecationWarning):
        TF.create_wbnet("lightcnn", device="cpu", ebp_version=3)


def test_factory_checkpoints(tmp_path, monkeypatch):
    """A LightCNN checkpoint ({"state_dict": ...} with DataParallel's
    "module." prefixes) loads with the prefixes stripped; a VGGFace2
    checkpoint without fc1 gets a runtime-initialized fc1.  The builders
    are cut to small graphs for the test (the branches' arguments are
    what is under test)."""
    from xfr_torch.models import factory as TF

    small_l = TL.build_lightcnn29v2(num_classes=7, layers=(1, 1, 1, 1))
    monkeypatch.setattr(TF.LCNN, "build_lightcnn29v2",
                        lambda num_classes: small_l)
    params = TC.init_params(small_l[1], seed=3)
    sd = {}
    for pname, p in params.items():
        for k, v in p.items():
            sd["module.%s.%s" % (pname, {"w": "weight",
                                          "b": "bias"}[k])] = v
    path = str(tmp_path / "lightcnn.pth.tar")
    torch.save({"state_dict": sd, "epoch": 3}, path)
    wb = TF.create_wbnet("lightcnn", device="cpu", weights_path=path)
    for pname, p in params.items():
        for k, v in p.items():
            np.testing.assert_array_equal(wb.net.params[pname][k].numpy(),
                                          v.numpy())

    g = GraphBuilder("vf2")
    x = g.conv2d(0, 3, 4, 3, bias=False, name="feat_extract")
    enc = g.flatten(x)
    out = g.node("linear", (enc,), hooked=False, pname="fc1")
    g.param_shapes["fc1"] = {"w": (2, 4)}
    small_v = (g.finalize(out), g.param_shapes, enc)
    monkeypatch.setattr(TF.VF2, "build_resnet50_128", lambda: small_v)
    w = np.random.RandomState(1).randn(4, 3, 3, 3).astype(np.float32)
    path = str(tmp_path / "resnet50_128.pth")
    torch.save({"feat_extract.weight": torch.from_numpy(w)}, path)
    wb = TF.create_wbnet("vggface2_resnet50", device="cpu",
                         weights_path=path)
    np.testing.assert_array_equal(
        wb.net.params["feat_extract"]["w"].numpy(), w)
    fc1 = TC.init_params({"fc1": {"w": (2, 4)}}, seed=0)["fc1"]["w"]
    np.testing.assert_array_equal(wb.net.params["fc1"]["w"].numpy(),
                                  fc1.numpy())


def test_checkpoint_round_trip(tmp_path):
    """save_params then load_params: equal tensors; with a template each
    takes the template's dtype and device."""
    params = TC.init_params(BUILDERS["vgg16_reduced"][1](
        **BUILDERS["vgg16_reduced"][2])[1], seed=2)
    path = TCK.save_params(params, str(tmp_path / "p.pt"))
    back = TCK.load_params(path)
    assert sorted(back) == sorted(params)
    for k in params:
        for kk in params[k]:
            assert back[k][kk].dtype == torch.float32
            np.testing.assert_array_equal(back[k][kk].numpy(),
                                          params[k][kk].numpy())
    template = TC.params_to(params, "cpu", dtype=torch.float64)
    back = TCK.load_params(path, template=template)
    assert back["fc6"]["w"].dtype == torch.float64
    np.testing.assert_array_equal(back["fc6"]["w"].numpy(),
                                  params["fc6"]["w"].double().numpy())


# ---------------------------------------------------------------------------
# Preprocessing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("hw", [(250, 180), (128, 128), (97, 301)])
def test_preprocessors_match_jax(hw):
    """preprocess_lightcnn, preprocess_vggface2 and preprocess_vggface on
    a uint8 image (and LightCNN's on its float form) equal to JAX's bit
    for bit; the batched forms at rtol 1e-6."""
    rng = np.random.RandomState(hw[0])
    img = rng.randint(0, 256, hw + (3,)).astype(np.uint8)
    for tf, jf in ((TL.preprocess_lightcnn, JL.preprocess_lightcnn),
                   (TV2.preprocess_vggface2, JV2.preprocess_vggface2),
                   (TV.preprocess_vggface, JV.preprocess_vggface)):
        got = tf(img, device="cpu")
        want = np.asarray(jf(img))
        assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
        np.testing.assert_array_equal(got.numpy(), want)
    f = img.astype(np.float32) / 255.0
    np.testing.assert_array_equal(TL.preprocess_lightcnn(f, device="cpu"),
                                  np.asarray(JL.preprocess_lightcnn(f)))
    batch = rng.rand(2, 16, 16, 3).astype(np.float32)
    np.testing.assert_allclose(
        TL.preprocess_lightcnn_batch(torch.from_numpy(batch)).numpy(),
        np.asarray(JL.preprocess_lightcnn_batch(batch)), rtol=1e-6)
    np.testing.assert_allclose(
        TV2.preprocess_vggface2_batch(torch.from_numpy(batch * 255)).numpy(),
        np.asarray(JV2.preprocess_vggface2_batch(batch * 255)), rtol=1e-6)


def test_new_entry_points_refuse_missing_card():
    """The three preprocessors and the factory's new branches default to
    the card and raise without one."""
    from xfr_torch.models import create_wbnet

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    img = np.zeros((8, 8, 3), np.uint8)
    for fn in (TL.preprocess_lightcnn, TV2.preprocess_vggface2,
               TV.preprocess_vggface):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn(img)
    for name in ("lightcnn", "vggface2_resnet50", "senet50_256"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            create_wbnet(name)


def test_twin_whitebox_ebp_on_lightcnn_events_match_jax():
    """The engine's ebp on a reduced LightCNN twin built from the JAX net's
    nodes: its event schedule is the port builder's, and the pooled map
    equals JAX's (float32, rtol 1e-5, atol 1e-7 of the max)."""
    graph, shapes, enc = JL.build_lightcnn29v2(num_classes=6,
                                               layers=(1, 1, 1, 1))
    jwb = JWhitebox(JNet(graph, JC.init_params(shapes, seed=4),
                         encode_tensor=enc, classifier_pname="fc2",
                         num_classes=6),
                    ebp_version=6, ebp_subtree_mode="affineonly_with_prior")
    twb = twin_whitebox(jwb, np.float32)
    tg, _, _ = TL.build_lightcnn29v2(num_classes=6, layers=(1, 1, 1, 1))
    assert [dataclasses.astuple(e) for e in twb.net.graph.events] == \
        [dataclasses.astuple(e) for e in tg.events]
    x = np.random.RandomState(1).rand(1, 1, 128, 128).astype(np.float32)
    P = np.eye(6, dtype=np.float32)[3:4]
    want = jwb.ebp(jnp.asarray(x), jnp.asarray(P), mwp=True)
    got = twb.ebp(x, P, mwp=True)
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-7 * np.abs(want).max())
