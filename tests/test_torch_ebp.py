"""The port's EBP walk against the JAX package.

The pooled MWP at event n_events-2 (the mean-EBP prior's source) is held
against ``Whitebox._ebp_pooled_fn`` of the JAX package, with the JAX
net's parameters carried across.  Both run float64 inputs and cast the
MWP to float32 at the end, so the tolerance is float32 rounding: 2e-6
relative, and an absolute floor of 1e-6 of the map's maximum.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from xfr_tpu.ebp import interpreter as JI
from xfr_tpu.ebp.engine import Whitebox as JWhitebox
from xfr_tpu.ebp.engine import WhiteboxNetwork as JNet
from xfr_tpu.models import common as JC
from xfr_tpu.models import resnet101 as JR
from tests.fixtures import make_toy_wbnet
from tests.torch_fixtures import jax_params_np, torch_twin

from xfr_torch.ebp import interpreter as TI
from xfr_torch.ebp.engine import Whitebox, WhiteboxNetwork
from xfr_torch.models import resnet101 as TR
from xfr_torch.models.convert import params_from_jax


def _assert_mwp_close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=2e-6,
                               atol=1e-6 * np.abs(want).max())


def _pooled_both(jwb, twb, x, n):
    Pn = np.full((1, n), 1.0 / n)
    jparams = {k: {kk: jnp.asarray(vv, jnp.float64) for kk, vv in v.items()}
               for k, v in jwb.net.params.items()}
    jpooled, jP = jwb._ebp_pooled_fn()(jparams, jnp.asarray(x),
                                       jnp.asarray(Pn))
    tpooled, tP = twb._ebp_pooled_fn()(twb.net.params, torch.from_numpy(x),
                                       torch.from_numpy(Pn))
    return (jpooled, jP), (tpooled.numpy(), tP.numpy())


@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("mode", ["affineonly", "affineonly_with_prior",
                                  "norelu", "all"])
def test_toy_pooled_mwp_matches_jax(mode, with_bias):
    jwb = make_toy_wbnet(num_classes=5, seed=1, subtree_mode=mode)
    jwb = JWhitebox(jwb.net, ebp_version=6, ebp_subtree_mode=mode,
                    eps=jwb.eps, with_bias=with_bias)
    twb = torch_twin(jwb, np.float64, with_bias=with_bias)
    x = np.random.RandomState(4).rand(1, 3, 224, 224) * 255 - 120
    (jpooled, jP), (tpooled, tP) = _pooled_both(jwb, twb, x, 5)
    assert tpooled.shape == (1, 56, 56) and tP.shape == (1, 8, 56, 56)
    _assert_mwp_close(tpooled, jpooled)
    _assert_mwp_close(tP, jP)


def test_toy_every_event_priors_and_truncation_match_jax():
    """All events of one walk at float64, then a prior-injected walk with
    a zero cotangent truncated at the prior's node (start_node)."""
    jwb = make_toy_wbnet(num_classes=5, seed=2,
                         subtree_mode="affineonly_with_prior")
    g = jwb.net.graph
    jparams = {k: {kk: jnp.asarray(vv, jnp.float64) for kk, vv in v.items()}
               for k, v in jwb.net.params.items()}
    twb = torch_twin(jwb, np.float64)
    tg, tparams = twb.net.graph, twb.net.params
    rng = np.random.RandomState(5)
    x = rng.rand(1, 3, 224, 224) * 255 - 120
    Pn = np.eye(5)[[2]]
    kw = dict(subtree_mode="affineonly_with_prior", eps=1e-12)
    jout = JI.ebp(g, jparams, jnp.asarray(x), jnp.asarray(Pn), **kw)
    tout = TI.ebp(tg, tparams, torch.from_numpy(x), torch.from_numpy(Pn),
                  **kw)
    assert sorted(jout) == sorted(tout) == list(range(g.n_events))
    for k in jout:
        np.testing.assert_allclose(tout[k].numpy(), np.asarray(jout[k]),
                                   rtol=1e-9, atol=1e-12, err_msg=str(k))

    ev = 4
    prior = np.zeros(np.asarray(jout[ev]).shape)
    prior.reshape(-1)[int(np.argmax(np.asarray(jout[ev])))] = 1.0
    jv = JI.forward_clean(g, jparams, jnp.asarray(x))
    jpv = JI.forward_positive(g, jparams, jv)
    tv = TI.forward_clean(tg, tparams, torch.from_numpy(x))
    tpv = TI.forward_positive(tg, tparams, tv)
    zero = np.zeros_like(Pn)
    jr = JI.ebp_backward(g, jparams, jv, jpv, jnp.asarray(zero),
                         priors={ev: jnp.asarray(prior)},
                         start_node=g.event_node[ev], **kw)
    # the port's walk takes a row axis: one row here
    tr = TI.ebp_backward(tg, tparams, tv, tpv, torch.from_numpy(zero)[None],
                         priors={ev: torch.from_numpy(prior)},
                         start_node=tg.event_node[ev], **kw)
    assert sorted(jr) == sorted(tr)
    for k in jr:
        np.testing.assert_allclose(tr[k][0].numpy(), np.asarray(jr[k]),
                                   rtol=1e-9, atol=1e-12, err_msg=str(k))


def test_reduced_resnet101_norelu_pooled_mwp_matches_jax():
    graph, shapes, enc = JR.build_resnet101(num_classes=16,
                                            layers=(1, 1, 1, 1))
    params = JC.init_params(shapes, seed=0)
    jnet = JNet(graph, params, encode_tensor=enc, classifier_pname="fc2",
                num_classes=16)
    jwb = JWhitebox(jnet, ebp_version=6, ebp_subtree_mode="norelu")
    tgraph, _, tenc = TR.build_resnet101(num_classes=16, layers=(1, 1, 1, 1))
    tnet = WhiteboxNetwork(tgraph, params_from_jax(
        jax_params_np(params, np.float64), device="cpu"),
        encode_tensor=tenc, classifier_pname="fc2", num_classes=16)
    twb = Whitebox(tnet, ebp_version=6, ebp_subtree_mode="norelu")
    x = np.random.RandomState(6).rand(1, 3, 224, 224) * 255 - 120
    (jpooled, _), (tpooled, tP) = _pooled_both(jwb, twb, x, 16)
    assert tpooled.shape == (1, 112, 112) and tP.shape == (1, 64, 112, 112)
    _assert_mwp_close(tpooled, jpooled)
    # Whitebox.ebp: the saliency post-processing on the host
    sal = twb.ebp(x, np.full((1, 16), 1.0 / 16, np.float32))
    jsal = jwb.ebp(jnp.asarray(x, jnp.float32),
                   jnp.full((1, 16), 1.0 / 16, jnp.float32))
    assert sal.shape == (112, 112)
    np.testing.assert_allclose(sal, jsal, rtol=1e-4,
                               atol=1e-6 * np.abs(jsal).max())


def test_embeddings_pad_and_normalize_like_jax():
    """encode/embeddings (trailing-batch padding to batch_size, host
    normalization) on the toy net; float32, TF32 does not exist on the
    CPU, so the only difference is summation order."""
    jwb = make_toy_wbnet(num_classes=4, seed=3)
    twb = torch_twin(jwb)
    jwb.batch_size = twb.batch_size = 4
    x = (np.random.RandomState(7).rand(6, 3, 224, 224) * 255 - 120
         ).astype(np.float32)
    got = twb.embeddings(x)
    want = jwb.embeddings(x)
    assert got.shape == (6, 12)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, rtol=1e-6)
    np.testing.assert_allclose(twb.embeddings(list(x[:3])), want[:3],
                               rtol=1e-5, atol=1e-6)
