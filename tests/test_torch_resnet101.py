"""xfr_torch ResNet-101+L2 and its parameters against the JAX package.

Tolerance of the float64 forward: 1e-9 relative / 1e-10 absolute — both
packages run float64 on the CPU through ~60 ops, and only the summation
order of the convolutions differs.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from xfr_tpu.ebp import interpreter as JI
from xfr_tpu.models import common as JC
from xfr_tpu.models import convert as JCV
from xfr_tpu.models import resnet101 as JR

from xfr_torch.ebp import interpreter as TI
from xfr_torch.models import common as TC
from xfr_torch.models import convert as TCV
from xfr_torch.models import resnet101 as TR
from tests.torch_fixtures import jax_params_np


@pytest.fixture(scope="module")
def small_resnet():
    graph, shapes, enc = JR.build_resnet101(num_classes=16,
                                            layers=(1, 1, 1, 1))
    tgraph, _, _ = TR.build_resnet101(num_classes=16, layers=(1, 1, 1, 1))
    params = JC.init_params(shapes, seed=3, dtype=jnp.float64)
    return graph, tgraph, shapes, enc, params


def test_init_params_bit_for_bit(small_resnet):
    _, _, shapes, _, _ = small_resnet
    jp = JC.init_params(shapes, seed=7)
    tp = TC.init_params(shapes, seed=7)
    assert sorted(jp) == sorted(tp)
    for k in jp:
        assert sorted(jp[k]) == sorted(tp[k])
        for kk in jp[k]:
            assert tp[k][kk].dtype == torch.float32
            np.testing.assert_array_equal(tp[k][kk].numpy(),
                                          np.asarray(jp[k][kk]))


def test_forward_every_tensor_matches_jax(small_resnet):
    graph, tgraph, _, enc, params = small_resnet
    x = np.random.RandomState(0).randn(2, 3, 224, 224) * 50
    jv = JI.forward_clean(graph, params, jnp.asarray(x))
    tparams = TCV.params_from_jax(jax_params_np(params), device="cpu")
    tv = TI.forward_clean(tgraph, tparams, torch.from_numpy(x))
    assert len(tv) == len(jv) == graph.n_tensors
    for t, (a, b) in enumerate(zip(jv, tv)):
        assert b.dtype == torch.float64, t
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-9,
                                   atol=1e-10, err_msg=f"tensor {t}")
    # the freeing forward returns the same kept tensors and nothing else
    kept = TI.forward_clean(tgraph, tparams, torch.from_numpy(x),
                            keep=(enc,))
    assert [t for t, v in enumerate(kept) if v is not None] == [enc]
    np.testing.assert_array_equal(kept[enc].numpy(), tv[enc].numpy())


def _state_dict(param_shapes, params):
    """Inverse of params_from_state_dict: {torch key: tensor}."""
    sd = {}
    for pname, shapes in param_shapes.items():
        key_map = TCV._key_map(shapes)
        for key in shapes:
            sd[f"{pname}.{key_map[key]}"] = params[pname][key]
    return sd


def test_state_dict_round_trip(small_resnet):
    _, _, shapes, _, params = small_resnet
    tparams = TCV.params_from_jax(jax_params_np(params, np.float32),
                                  device="cpu")
    sd = _state_dict(shapes, tparams)
    assert "layer1.0.bn1.running_var" in sd and "fc2.weight" in sd
    back = TCV.params_from_state_dict(shapes, sd, device="cpu")
    jback = JCV.params_from_state_dict(
        shapes, {k: v.numpy() for k, v in sd.items()})
    for k in shapes:
        for kk in shapes[k]:
            np.testing.assert_array_equal(back[k][kk].numpy(),
                                          tparams[k][kk].numpy())
            np.testing.assert_array_equal(back[k][kk].numpy(),
                                          np.asarray(jback[k][kk]))
    # strict shape check and missing keys raise like the JAX package
    bad = dict(sd)
    bad["fc1.weight"] = torch.zeros(3, 3)
    with pytest.raises(ValueError):
        TCV.params_from_state_dict(shapes, bad, device="cpu")
    del bad["fc1.weight"]
    with pytest.raises(KeyError):
        TCV.params_from_state_dict(shapes, bad, device="cpu")
    # runtime_init: a missing pname is initialized as the JAX package does
    del bad["fc1.bias"]
    ri = TCV.params_from_state_dict(shapes, bad, runtime_init=("fc1",),
                                    device="cpu")
    jri = JCV.params_from_state_dict(
        shapes, {k: v.numpy() for k, v in bad.items()},
        runtime_init=("fc1",))
    np.testing.assert_array_equal(ri["fc1"]["w"].numpy(),
                                  np.asarray(jri["fc1"]["w"]))


def test_preprocess_batch_matches_jax():
    imgs = np.random.RandomState(2).rand(2, 224, 224, 3).astype(
        np.float32) * 255
    got = TR.preprocess_resnet101_batch(torch.from_numpy(imgs)).numpy()
    want = np.asarray(JR.preprocess_resnet101_batch(imgs))
    np.testing.assert_array_equal(got, want)
    assert (TR.RESNETV6_MATCH_THRESHOLD, TR.RESNETV4_PLATTS_SCALING) == \
        (JR.RESNETV6_MATCH_THRESHOLD, JR.RESNETV4_PLATTS_SCALING)
    np.testing.assert_array_equal(TR.MEAN_RGB, JR.MEAN_RGB)


def test_preprocess_image_matches_jax():
    """One HWC uint8 image through the PIL resize: exact, both sides cast
    the same float64 difference to float32."""
    im = (np.random.RandomState(3).rand(100, 140, 3) * 255).astype(np.uint8)
    got = TR.preprocess_resnet101(im, device="cpu")
    assert got.device.type == "cpu" and got.shape == (1, 3, 224, 224)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(JR.preprocess_resnet101(im)))
