"""xfr_torch.blackbox.masks against xfr_tpu.blackbox.masks.

Float64 cases (resizes, crops) are held to 1e-12; the float32 ones
(blur, prior grid) to 1e-5 relative, the float32 rounding of a ~70-tap
sum taken in another order.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from xfr_tpu.blackbox import masks as JM

from xfr_torch.blackbox import masks as TM
from tests import torch_fixtures  # noqa: F401  (sets torch threads)


@pytest.mark.parametrize("shape,sigma", [((31, 29), 0.8), ((31, 29), 2.0),
                                         ((31, 29), 5.0), ((24, 24, 3), 2.0),
                                         ((224, 224, 3), 8.96),
                                         ((4, 20, 18), 1.5)])
def test_gaussian_blur_matches_jax(shape, sigma):
    img = np.random.RandomState(0).rand(*shape).astype(np.float32) * 255
    got = TM.gaussian_blur(torch.from_numpy(img), sigma).numpy()
    want = np.asarray(JM.gaussian_blur(jnp.asarray(img), sigma))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("src,dst", [((224, 224), (19, 19)),
                                     ((112, 112), (224, 224)),
                                     ((19, 19), (236, 236)),
                                     ((30, 20), (7, 5))])
def test_resize_bilinear_matches_jax(src, dst):
    img = np.random.RandomState(1).rand(3, *src)
    got = TM.resize_bilinear(torch.from_numpy(img), dst).numpy()
    want = np.asarray(JM.resize_bilinear(jnp.asarray(img), dst))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("prior_type", ["mean_ebp", "uniform"])
def test_prior_to_grid_matches_jax(prior_type):
    rng = np.random.RandomState(2)
    prior = (rng.rand(224, 224) ** 4).astype(np.float32)
    prior /= prior.sum()
    got = TM.prior_to_grid(torch.from_numpy(prior), 12, prior_type).numpy()
    want = np.asarray(JM.prior_to_grid(jnp.asarray(prior), 12, prior_type))
    assert got.shape == (19, 19)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-8)
    np.testing.assert_array_equal(got > 0, want > 0)


def test_prior_to_grid_of_constant_prior_is_uniform_on_its_support():
    """A constant prior (the uniform prior) blurs and resizes to a grid
    equal up to float32 rounding, and the percentile clip then keeps the
    cells that rounding left at the top: which ones depends on summation
    order (338 of 361 in the JAX package on the CPU), so the two packages
    keep different cells.  Both give a uniform distribution over at
    least half of the grid."""
    prior = np.ones((224, 224), np.float32)
    for grid in (TM.prior_to_grid(torch.from_numpy(prior), 12,
                                  "uniform").numpy(),
                 np.asarray(JM.prior_to_grid(jnp.asarray(prior), 12,
                                             "uniform"))):
        support = grid > 0
        assert support.sum() >= 181
        np.testing.assert_allclose(grid[support], 1.0 / support.sum(),
                                   rtol=1e-6)
        assert np.all(grid[~support] == 0)


@pytest.mark.parametrize("args", [((224, 224), 12, 181, 50.0),
                                  ((224, 224), 12, 182, 50.0),
                                  ((64, 64), 8, 65, 0.0),
                                  ((64, 64), 8, 64, 0.0)])
def test_check_grid_capacity_raises_like_jax(args):
    def outcome(fn):
        try:
            fn(*args[:3], pct=args[3])
        except ValueError as e:
            return str(e)
        return None

    assert outcome(TM.check_grid_capacity) == \
        outcome(JM.check_grid_capacity)
    assert (outcome(TM.check_grid_capacity) is None) == (args[2] in (181, 64))


def test_sparse_grids_from_jax_noise_match_jax_top_k():
    """The same Gumbel noise (JAX's own draw) through the port's top-k
    gives exactly the grids of JAX's sample_sparse_grids."""
    rng = np.random.RandomState(3)
    probs = rng.rand(19, 19).astype(np.float32)
    probs[probs < np.median(probs)] = 0
    probs /= probs.sum()
    key = jax.random.PRNGKey(11)
    want = np.asarray(JM.sample_sparse_grids(key, jnp.asarray(probs), 50, 2))
    noise = np.array(jax.random.gumbel(key, (50, 361), jnp.float32))
    got = TM.sparse_grids_from_noise(torch.from_numpy(probs),
                                     torch.from_numpy(noise), 2).numpy()
    np.testing.assert_array_equal(got, want)
    assert np.all((1 - got).sum(axis=(1, 2)) == 2)


def test_sample_sparse_grids_respects_prior_support():
    gen = torch.Generator().manual_seed(0)
    probs = torch.zeros(6, 6)
    probs[2:4, 2:4] = 0.25
    grids = TM.sample_sparse_grids(gen, probs, 64, 2).numpy()
    zeros = 1.0 - grids
    assert np.all(zeros.sum(axis=(1, 2)) == 2)
    support = np.zeros((6, 6), bool)
    support[2:4, 2:4] = True
    assert np.all(zeros[:, ~support] == 0) and zeros.max() == 1.0


@pytest.mark.parametrize("size,scale", [((224, 224), 12), ((96, 80), 12)])
def test_upsample_shift_masks_static_matches_jax(size, scale):
    rng = np.random.RandomState(4)
    gh, gw = -(-size[0] // scale), -(-size[1] // scale)
    grids = (rng.rand(5, gh, gw) > 0.3).astype(np.float64)
    shifts = rng.randint(0, scale, (5, 2)).astype(np.int32)
    got = TM.upsample_shift_masks_static(
        torch.from_numpy(grids), torch.from_numpy(shifts), size,
        scale).numpy()
    want = np.asarray(JM.upsample_shift_masks_static(
        jnp.asarray(grids), jnp.asarray(shifts), size, scale))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def test_make_masks_draws_grids_then_shifts():
    """make_masks consumes its generator as grids first, then shifts — the
    order of the fused-blend branch, so one seed gives one mask set."""
    prior = torch.ones(64, 64)
    masks = TM.make_masks(torch.Generator().manual_seed(5), prior, 16, 8, 1,
                          prior_type="uniform")
    gen = torch.Generator().manual_seed(5)
    grids = TM.sample_sparse_grids(gen, TM.prior_to_grid(prior, 8,
                                                         "uniform"), 16, 1)
    shifts = TM.random_shifts(gen, 16, 8, "cpu")
    again = TM.upsample_shift_masks_static(grids, shifts, (64, 64), 8)
    np.testing.assert_array_equal(masks.numpy(), again.numpy())
    assert masks.shape == (16, 64, 64)
    assert masks.min() >= -1e-6 and masks.max() <= 1 + 1e-6
    hidden = (1.0 - masks).sum(dim=(1, 2)).numpy()
    assert np.all(hidden > 10) and np.all(hidden < 300)
    flat = TM.make_masks(torch.Generator().manual_seed(5), prior, 4, 8, 1,
                         prior_type="uniform", random_shift=False)
    assert flat.shape == (4, 64, 64)
