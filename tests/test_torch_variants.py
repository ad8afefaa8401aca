"""The rest of the port's whitebox API against the JAX package:
``layerwise_ebp`` (argmax, elementwise), the deprecated
``layerwise_contrastive_ebp`` in its 8 prior modes, ``subtree_ebp`` in
both percentile modes (mirroring tests/test_engine_variants.py and
tests/test_subtree_ebp.py value for value), STRise's uint8 mean-EBP
prior, and the layerwise entries of ``demo/whitebox_goldens.npz``.

The toy-net maps run float32 on both sides (the JAX package casts a
float32 probe's walk to float32): held at rtol 1e-5 / atol 1e-7 of the
map's max.  The subtree tests run the oracle nets in float64; their maps
pass through float32 blurs in both packages: held at rtol 1e-6 with
equal selections, scores at rtol 1e-10.
"""

import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests.fixtures import make_toy_wbnet
from tests.oracles import nets as N
from tests.torch_fixtures import torch_twin, twin_whitebox
from tests.test_torch_whitebox import (_golden_whitebox,  # noqa: F401
                                       resnet_golden)
from xfr_tpu.ebp.engine import Whitebox as JWhitebox
from xfr_tpu.ebp.engine import WhiteboxNetwork as JNet

from xfr_torch.ebp.engine import Whitebox

LW_MODES = ["copy", "mean", "product", "argmax", "argmax_product",
            "percentile", "percentile_argmax", "elementwise"]


def _close_to_max(got, want, rtol=1e-5, atol=1e-7):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol * max(np.abs(want).max(), 1e-30))


@pytest.fixture(scope="module")
def toy():
    """tests/test_engine_variants.py's net and probe, and the port's
    twin."""
    jwb = make_toy_wbnet(subtree_mode="all", seed=3)
    probe = np.random.RandomState(3).rand(1, 3, 224, 224).astype(np.float32)
    return jwb, torch_twin(jwb), probe


def _peak_element(twb, probe, k_layer):
    """The flat element of event ``k_layer``'s largest mate MWP value: the
    elementwise modes then inject something."""
    P = twb._ebp_raw_fn((k_layer,))(twb.net.params, torch.from_numpy(probe),
                                    twb._onehot(2))[k_layer]
    return int(P.reshape(-1).argmax())


@pytest.mark.parametrize("mode", ["argmax", "elementwise"])
def test_layerwise_ebp_matches_jax(toy, mode):
    jwb, twb, probe = toy
    k_layer = jwb._n_events // 2
    kw = dict(k_poschannel=2, mwp=True)
    if mode == "elementwise":
        kw["k_element"] = _peak_element(twb, probe, k_layer)
    want = jwb.layerwise_ebp(jnp.asarray(probe), k_layer, mode=mode, **kw)
    got = twb.layerwise_ebp(probe, k_layer, mode=mode, **kw)
    assert got.shape == (56, 56) and got.max() > 0 and got.min() >= 0
    _close_to_max(got, want)
    # the saliency form, and the refusal of an unknown mode
    kw["mwp"] = False
    _close_to_max(twb.layerwise_ebp(probe, k_layer, mode=mode, **kw),
                  jwb.layerwise_ebp(jnp.asarray(probe), k_layer, mode=mode,
                                    **kw))
    with pytest.raises(ValueError):
        twb.layerwise_ebp(probe, k_layer, mode="nope")


@pytest.mark.parametrize("mode", LW_MODES)
def test_layerwise_contrastive_ebp_modes_match_jax(toy, mode):
    jwb, twb, probe = toy
    k_layer = jwb._n_events // 2
    kw = dict(k_poschannel=2, k_negchannel=3, k_layer=k_layer, mode=mode,
              percentile=80, k_element=_peak_element(twb, probe, k_layer),
              gradlayer=None, mwp=True)
    with pytest.warns(UserWarning, match="deprecated"):
        got = twb.layerwise_contrastive_ebp(probe, **kw)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = jwb.layerwise_contrastive_ebp(jnp.asarray(probe), **kw)
    assert got.shape == (56, 56) and np.isfinite(got).all()
    _close_to_max(got, want)
    with pytest.warns(UserWarning):
        with pytest.raises(ValueError):
            twb.layerwise_contrastive_ebp(probe, 2, 3, k_layer, mode="nope")


def test_argmax_layerwise_concentrates(toy):
    """An argmax-prior layerwise map holds no more mass than full EBP."""
    _, twb, probe = toy
    Pn = np.eye(5, dtype=np.float32)[2:3]
    full = twb.ebp(probe, Pn, mwp=True)
    lw = twb.layerwise_ebp(probe, twb._n_events - 4, mode="argmax",
                           k_poschannel=2, mwp=True)
    assert lw.sum() <= full.sum() * (1 + 1e-3)


@pytest.mark.parametrize("ebp_version,with_bias", [(11, None), (6, True),
                                                   (5, None), (11, False)])
def test_ebp_version_flags_match_jax(toy, ebp_version, with_bias):
    """The ebp_version flags: version 11 turns the positive-bias swap on,
    ``with_bias`` overrides it either way, a version other than 6 gives
    uint8 maps.  The flags equal JAX's, and so do ebp and layerwise_ebp
    under them (float maps at rtol 1e-5 / atol 1e-7 of the max, uint8
    maps to one step)."""
    jwb0, _, probe = toy
    jwb = JWhitebox(jwb0.net, ebp_version=ebp_version, with_bias=with_bias,
                    ebp_subtree_mode="all", eps=jwb0.eps)
    twb = twin_whitebox(jwb, with_bias=with_bias)
    assert (twb._ebp_with_bias, twb.convert_saliency_uint8) == \
        (jwb._ebp_with_bias, jwb.convert_saliency_uint8)
    assert twb._ebp_with_bias == (ebp_version == 11 if with_bias is None
                                  else with_bias)
    P = np.eye(5, dtype=np.float32)[2:3]
    k_layer = jwb._n_events // 2
    pairs = [(twb.ebp(probe, P), jwb.ebp(jnp.asarray(probe),
                                         jnp.asarray(P))),
             (twb.layerwise_ebp(probe, k_layer, k_poschannel=2, mwp=False),
              jwb.layerwise_ebp(jnp.asarray(probe), k_layer, k_poschannel=2,
                                mwp=False))]
    for got, want in pairs:
        assert got.dtype == want.dtype
        if want.dtype == np.uint8:
            assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
        else:
            _close_to_max(got, want)


# ---------------------------------------------------------------------------
# subtree_ebp on the oracle nets (tests/test_subtree_ebp.py's setups)
# ---------------------------------------------------------------------------


def _oracle_pair(netname, seed=0, mutate=None):
    make, shape = N.ALL_NETS[netname]
    tnet, graph, params, _ = make(seed)
    if mutate is not None:
        params = mutate(tnet, dict(params))
    jwb = JWhitebox(JNet(graph, params, encode_tensor=graph.output_id,
                         classifier_pname="fc2", num_classes=5,
                         name=netname),
                    ebp_version=6, ebp_subtree_mode="all", eps=1e-12)
    return jwb, twin_whitebox(jwb), shape


def _subtree_equal(got, want):
    (s_t, sc_t, k_t), (s_j, sc_j, k_j) = got, want
    assert k_t == k_j
    np.testing.assert_allclose(sc_t, sc_j, rtol=1e-10)
    assert s_t.shape == s_j.shape
    np.testing.assert_allclose(s_t, s_j, rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("netname", list(N.ALL_NETS))
@pytest.mark.parametrize("mode", ["percentile_argmax", "percentile"])
def test_subtree_ebp_matches_jax(netname, mode):
    jwb, twb, shape = _oracle_pair(netname)
    x = torch.randn(shape, generator=torch.Generator().manual_seed(11),
                    dtype=torch.float64).numpy()
    kw = dict(percentile=20, mode=mode, topk=3)
    _subtree_equal(twb.subtree_ebp(x, 2, 3, **kw),
                   jwb.subtree_ebp(jnp.asarray(x), 2, 3, **kw))


def test_subtree_ebp_topk1_default_and_refusal():
    """The default call (percentile 20, percentile_argmax, topk 1): one
    subtree, a unit-mass map; a mode without "percentile" is refused."""
    jwb, twb, shape = _oracle_pair("chain")
    x = torch.randn(shape, generator=torch.Generator().manual_seed(11),
                    dtype=torch.float64).numpy()
    got = twb.subtree_ebp(x, 2, 3)
    _subtree_equal(got, jwb.subtree_ebp(jnp.asarray(x), 2, 3))
    assert len(got[2]) == 1
    np.testing.assert_allclose(got[0].sum(), 1.0, rtol=1e-5)
    with pytest.raises(AssertionError):
        twb.subtree_ebp(x, 2, 3, mode="argmax")


def test_subtree_ebp_tied_maxima_match_jax():
    """tests/test_subtree_ebp.py's channel surgery: conv1 channels 0/1
    identical and boosted, so their MWP planes tie and hold the maximum.
    The rank pass counts the ties as JAX's does, and the exact tied-prior
    fallback gives JAX's scores, selection and map."""
    def mutate(tnet, params):
        with torch.no_grad():
            tnet.conv1.weight[0] *= 10.0
            tnet.conv1.weight[1] = tnet.conv1.weight[0]
            tnet.conv1.bias[1] = tnet.conv1.bias[0]
            tnet.conv1.weight[2:] *= 0.05
            tnet.conv1.bias[2:] *= 0.05
            for attr in ("weight", "bias", "running_mean", "running_var"):
                getattr(tnet.bn1, attr)[1] = getattr(tnet.bn1, attr)[0]
            tnet.conv2.weight[:, 1] = tnet.conv2.weight[:, 0]
        params["conv1"] = N.conv_params(tnet.conv1)
        params["bn1"] = N.bn_params(tnet.bn1)
        params["conv2"] = N.conv_params(tnet.conv2)
        return params

    jwb, twb, shape = _oracle_pair("chain", mutate=mutate)
    x = torch.rand(shape, generator=torch.Generator().manual_seed(21),
                   dtype=torch.float64).numpy()
    Pns = torch.stack([twb._onehot(2), twb._onehot(3)])
    elems, vals, scores, ties = twb._subtree_rank_fn(True)(
        twb.net.params, torch.from_numpy(x), Pns, 20.0)
    j_el, j_v, j_sc, j_ties = jwb._subtree_rank_fn(True)(
        jwb.net.params, jnp.asarray(x),
        jnp.stack([jwb._onehot(2), jwb._onehot(3)]), 20.0)
    np.testing.assert_array_equal(ties.numpy(), np.asarray(j_ties))
    np.testing.assert_array_equal(elems.numpy(), np.asarray(j_el))
    np.testing.assert_allclose(vals.numpy(), np.asarray(j_v), rtol=1e-10)
    np.testing.assert_allclose(scores.numpy(), np.asarray(j_sc), rtol=1e-10)
    assert (ties.numpy()[vals.numpy() > 0] > 1).any(), \
        "channel surgery produced no ties"
    kw = dict(percentile=20, mode="percentile_argmax", topk=3)
    _subtree_equal(twb.subtree_ebp(x, 2, 3, **kw),
                   jwb.subtree_ebp(jnp.asarray(x), 2, 3, **kw))


def test_subtree_ebp_uint8_map_matches_jax():
    """ebp_version 5: the merged map goes through the uint8 conversion;
    equal to JAX's up to one uint8 step."""
    jwb0, _, shape = _oracle_pair("reslike")
    jwb = JWhitebox(jwb0.net, ebp_version=5, ebp_subtree_mode="all",
                    eps=1e-12)
    twb = twin_whitebox(jwb)
    x = torch.randn(shape, generator=torch.Generator().manual_seed(5),
                    dtype=torch.float64).numpy()
    s_t, sc_t, k_t = twb.subtree_ebp(x, 1, 4, topk=2)
    s_j, sc_j, k_j = jwb.subtree_ebp(jnp.asarray(x), 1, 4, topk=2)
    assert k_t == k_j and s_t.dtype == np.uint8
    assert np.abs(s_t.astype(int) - s_j.astype(int)).max() <= 1


# ---------------------------------------------------------------------------
# STRise's uint8 mean-EBP prior
# ---------------------------------------------------------------------------


def test_strise_uint8_prior_matches_jax():
    """With an ebp_version 5 mean-EBP net the prior is wb.ebp's uint8
    saliency map (host PIL blur), resized to 224 on the device: equal to
    JAX's up to one uint8 step of the map, so within 1/255 of its max."""
    from xfr_tpu.blackbox.strise import STRise as JSTRise
    from xfr_torch.blackbox.strise import STRise

    jwb0 = make_toy_wbnet(num_classes=4, seed=0, subtree_mode="norelu")
    jwb = JWhitebox(jwb0.net, ebp_version=5, ebp_subtree_mode="norelu",
                    eps=jwb0.eps)
    twb = twin_whitebox(jwb)
    assert twb.convert_saliency_uint8
    rng = np.random.RandomState(8)
    probe = rng.randint(0, 256, (224, 224, 3)).astype(np.uint8)
    gal = rng.randint(0, 256, (224, 224, 3)).astype(np.uint8)
    kw = dict(probe=probe, refs=[probe], gallery=[gal],
              black_box="resnetv6_pytorch", prior_type="mean_ebp",
              num_masks=8)
    jst = JSTRise(net_dict={("resnetv4_pytorch", None): jwb,
                            ("resnetv6_pytorch", 6): jwb}, **kw)
    tst = STRise(device="cpu", net_dict={("resnetv4_pytorch", None): twb,
                                         ("resnetv6_pytorch", 6): twb},
                 **kw)
    jst.mean_ebp_prior()
    tst.mean_ebp_prior()
    want = np.asarray(jst.prior)
    got = tst.prior.numpy()
    assert got.shape == want.shape == (224, 224)
    assert want.max() > 100  # the uint8 scale
    np.testing.assert_allclose(got, want, rtol=0, atol=want.max() / 255)


# ---------------------------------------------------------------------------
# demo/whitebox_goldens.npz, layerwise entries (full ResNet-101)
# ---------------------------------------------------------------------------


def test_resnet_layerwise_goldens(resnet_golden):
    """layerwise_ebp_k37 (argmax prior at event 37, class 0) and
    layerwise_contrastive_ebp_mean (the em/2500, en/2500 triplet
    classifier, mean prior at event 37) from the port, with the JAX
    package's create_wbnet("resnetv4_pytorch") weights carried across,
    float32 at full depth.  Held at test_demo_goldens.py's tolerance.

    Both goldens are all-zero maps: event 37 is a ReLU, and in the net's
    norelu mode an event with a prior passes its incoming gradient, zero
    under the zero output cotangent, so the prior never reaches the
    input.  The port's maps are exactly zero too; the next test holds the
    two methods at non-zero events."""
    rg = resnet_golden
    wb = _golden_whitebox(rg, np.float32)
    maps = {"layerwise_ebp_k37": wb.layerwise_ebp(
        rg["x"], k_layer=37, mode="argmax", k_poschannel=0)}
    wb.net.set_triplet_classifier(rg["em"] / 2500.0, rg["en"] / 2500.0)
    with pytest.warns(UserWarning, match="deprecated"):
        maps["layerwise_contrastive_ebp_mean"] = \
            wb.layerwise_contrastive_ebp(rg["x"], 0, 1, k_layer=37,
                                         mode="mean")
    for name, m in maps.items():
        g = rg["golden"][name]
        assert m.shape == g.shape, (name, m.shape, g.shape)
        np.testing.assert_allclose(m, g, rtol=1e-3,
                                   atol=1e-5 * max(g.max(), 1e-12),
                                   err_msg=name)
        assert not m.any() and not g.any()


def test_reduced_resnet_layerwise_matches_jax():
    """layerwise_ebp (argmax) and layerwise_contrastive_ebp (mean, argmax)
    on ResNet-101 at full widths with one block a stage, norelu, float32,
    classes 0 and 1: at event 42 (a Conv2d) the maps are non-zero and
    within 1e-7 of JAX's max (rtol 1e-5); at event 38 (a ReLU) the norelu
    mode drops the prior, and both packages give zero maps."""
    from xfr_tpu.models import common as JC
    from xfr_tpu.models import resnet101 as JR

    graph, shapes, enc = JR.build_resnet101(num_classes=16,
                                            layers=(1, 1, 1, 1))
    jwb = JWhitebox(JNet(graph, JC.init_params(shapes, seed=1),
                         encode_tensor=enc, classifier_pname="fc2",
                         num_classes=16),
                    ebp_version=6, ebp_subtree_mode="norelu")
    twb = twin_whitebox(jwb, np.float32)
    assert [twb.net.graph.events[k].tag for k in (42, 38)] == \
        ["Conv2d", "ReLU"]
    x = (np.random.RandomState(2).rand(1, 3, 224, 224) * 50).astype(
        np.float32)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for k in (42, 38):
            got = [twb.layerwise_ebp(x, k, mode="argmax", k_poschannel=0)] + \
                [twb.layerwise_contrastive_ebp(x, 0, 1, k, mode=m, mwp=True)
                 for m in ("mean", "argmax")]
            want = [jwb.layerwise_ebp(jnp.asarray(x), k, mode="argmax",
                                      k_poschannel=0)] + \
                [jwb.layerwise_contrastive_ebp(jnp.asarray(x), 0, 1, k,
                                               mode=m, mwp=True)
                 for m in ("mean", "argmax")]
            for a, b in zip(got, want):
                assert a.shape == (112, 112)
                assert (b.max() > 0) == (k == 42)
                _close_to_max(a, b)
                assert a.any() == b.any()


def test_engine_refuses_a_sigmoid_net_walk():
    """Every walk of the new methods refuses a net with a Sigmoid event,
    as the existing ones do (subtree_ebp's rank pass included)."""
    from xfr_torch.ebp.engine import WhiteboxNetwork
    from xfr_torch.graph import GraphBuilder

    g = GraphBuilder("sig")
    x = g.conv2d(0, 1, 2, 3, padding=1, name="c")
    x = g.node("sigmoid", (x,))
    x = g.flatten(x)
    out = g.linear(x, 2 * 4 * 4, 3, name="fc2")
    params = {"c": {"w": torch.ones(2, 1, 3, 3), "b": torch.zeros(2)},
              "fc2": {"w": torch.ones(3, 32), "b": torch.zeros(3)}}
    wb = Whitebox(WhiteboxNetwork(g.finalize(out), params, encode_tensor=x,
                                  classifier_pname="fc2", num_classes=3))
    probe = np.ones((1, 1, 4, 4), np.float32)
    for call in (lambda: wb.layerwise_ebp(probe, 1),
                 lambda: wb.subtree_ebp(probe, 0, 1)):
        with pytest.raises(ValueError, match="special case"):
            call()
