"""The fused mask-blend kernel's plain version against the JAX Pallas
kernel (interpret mode on the CPU), with the tolerance of
tests/test_pallas_blend.py: rtol 1e-4, atol 1e-3 on 0..255-scale pixels
(the Pallas kernel builds the mask as two matrix products, the plain
version as a bilinear resize; both in float32)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from xfr_tpu.blackbox import masks as JM
from xfr_tpu.blackbox.pallas_blend import fused_mask_blend_preprocess as \
    jax_fused

from xfr_torch.blackbox import fused_blend as FB
from xfr_torch.blackbox import masks as TM
from tests import torch_fixtures  # noqa: F401  (sets torch threads)

MEAN = np.array([122.782, 117.001, 104.298], np.float32)


def _inputs(n, H, W, scale, seed=0):
    rng = np.random.RandomState(seed)
    gh, gw = -(-H // scale), -(-W // scale)
    grids = (rng.rand(n, gh, gw) > 0.2).astype(np.float32)
    shifts = rng.randint(0, scale, (n, 2)).astype(np.int32)
    probe = (rng.rand(H, W, 3) * 255).astype(np.float32)
    fill = np.asarray(JM.gaussian_blur(jnp.asarray(probe), 4.0))
    return grids, shifts, probe, fill


# (n, H, W): the Pallas test's shapes, and the main path's 224x224 with a
# 19x19 grid at scale 12
@pytest.mark.parametrize("n,H,W", [(6, 96, 96), (3, 224, 224)])
def test_reference_matches_pallas_interpret(n, H, W):
    scale = 12
    grids, shifts, probe, fill = _inputs(n, H, W, scale)
    want = np.asarray(jax_fused(
        jnp.asarray(grids), jnp.asarray(shifts), jnp.asarray(probe),
        jnp.asarray(fill), MEAN, mask_scale=scale, interpret=True))
    t = [torch.from_numpy(a) for a in (grids, shifts, probe, fill, MEAN)]
    got = FB.fused_mask_blend_preprocess_reference(*t, mask_scale=scale)
    assert got.shape == (n, 3, H, W) and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-3)


def test_wrapper_on_cpu_runs_plain_version_without_counting():
    grids, shifts, probe, fill = _inputs(4, 48, 40, 12, seed=1)
    t = [torch.from_numpy(a) for a in (grids, shifts, probe, fill, MEAN)]
    before = FB.fused_mask_blend_preprocess.launches
    got = FB.fused_mask_blend_preprocess(*t, mask_scale=12)
    assert FB.fused_mask_blend_preprocess.launches == before
    want = FB.fused_mask_blend_preprocess_reference(*t, mask_scale=12)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    # the plain version is upsample_shift_masks_static + blend - mean
    m = TM.upsample_shift_masks_static(t[0], t[1], (48, 40), 12)[..., None]
    blend = (m * t[2] + (1 - m) * t[3] - t[4]).permute(0, 3, 1, 2)
    np.testing.assert_array_equal(got.numpy(), blend.numpy())


def test_wrapper_refuses_other_devices():
    t = [torch.zeros((1, 2, 2), device="meta")]
    with pytest.raises(ValueError, match="unsupported device"):
        FB.fused_mask_blend_preprocess(t[0], None, None, None, None)

