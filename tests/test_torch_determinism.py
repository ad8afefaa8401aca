"""One input, one result: the row-batched max-pool vjp sums overlapping
windows in a fixed order (no scatter-add, whose order on a card is the
card's), and STRise draws its masks on the host from a CPU generator, so
one seed gives one mask set on every device.

The vjp is held against JAX's (``jax.vmap`` of ``jax.vjp`` of
``xfr_tpu.ops.maxpool2d``, select-and-scatter) in float64 within 1e-12 of
the largest cotangent; in bfloat16 against the port's own float32 result
within bfloat16 rounding of the sums (at most four windows cover an input
of a 3x3 stride-2 pool: 4 * 2**-8 of the largest cotangent).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xfr_torch import ops as TO
from xfr_torch.blackbox import masks as TM
from xfr_torch.blackbox.strise import STRise
from xfr_tpu import ops as JO

POOLS = {
    # ResNet-101's stem (models/resnet101.py): overlapping, padded
    "3x3s2p1": dict(kernel=3, stride=2, padding=1),
    # the VGGFace2 stem (models/vggface2.py): overlapping, ceil_mode
    "3x3s2ceil": dict(kernel=3, stride=2, ceil_mode=True),
    # LightCNN and VGG-16: disjoint windows
    "2x2s2": dict(kernel=2, stride=2),
}


def _jax_rows_vjp(x, g, attrs):
    """JAX's row-batched vjp: vmap of the op's vjp over the rows of g."""
    fn = lambda v: JO.maxpool2d({}, (v,), **attrs)  # noqa: E731
    _, vjp = jax.vjp(fn, jnp.asarray(x))
    return np.asarray(jax.vmap(lambda c: vjp(c)[0])(jnp.asarray(g)))


def _tied_input(rng, shape):
    """Small integers: most windows hold tied maxima, which go to the
    window's first maximum in both packages."""
    return rng.randint(0, 3, shape).astype(np.float64)


@pytest.mark.parametrize("pool,hw", [
    (pool, hw) for pool in ("3x3s2p1", "3x3s2ceil")
    for hw in ((13, 13), (14, 15), (28, 28))] + [
    # the nets' 2x2 pools see even planes (JAX's vmapped vjp cannot crop)
    ("2x2s2", hw) for hw in ((12, 12), (14, 16), (28, 28))])
def test_rows_maxpool_matches_jax_float64(pool, hw):
    """Three rows of cotangents over a [2, 3, H, W] capture with tied
    maxima: the port's vjp equals JAX's within 1e-12 of the largest
    cotangent, and the rows are independent (row r alone gives row r)."""
    attrs = POOLS[pool]
    rng = np.random.RandomState(sum(hw))
    x = _tied_input(rng, (2, 3) + hw)
    y = TO.maxpool2d({}, (torch.from_numpy(x),), **attrs)
    g = rng.randn(3, *y.shape)
    got = TO.op_vjp_rows("maxpool2d", {}, (torch.from_numpy(x),), attrs,
                         torch.from_numpy(g))[0].numpy()
    want = _jax_rows_vjp(x, g, attrs)
    assert got.shape == want.shape == (3, 2, 3) + hw
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-12 * np.abs(g).max())
    one = TO.op_vjp_rows("maxpool2d", {}, (torch.from_numpy(x),), attrs,
                         torch.from_numpy(g[1:2]))[0].numpy()
    np.testing.assert_array_equal(one[0], got[1])


def test_rows_maxpool_tie_goes_to_first_maximum():
    """A window of four equal values sends its whole cotangent to its
    first (top-left) element, in both packages; a 3x3 stride-2 pool's
    overlapping windows sum on the shared input."""
    x = np.ones((1, 1, 4, 4))
    g = np.arange(1.0, 5.0).reshape(1, 1, 1, 2, 2)
    got = TO.op_vjp_rows("maxpool2d", {}, (torch.from_numpy(x),),
                         POOLS["2x2s2"], torch.from_numpy(g))[0].numpy()
    want = np.zeros((1, 1, 1, 4, 4))
    want[..., 0, 0], want[..., 0, 2] = 1, 2
    want[..., 2, 0], want[..., 2, 2] = 3, 4
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _jax_rows_vjp(x, g,
                                                     POOLS["2x2s2"]))
    # 3x3/s2/p1 over a 3x3 plane of equal values: both windows' first
    # maximum inside the plane is (0, 0)
    x3 = np.ones((1, 1, 3, 3))
    g3 = np.arange(1.0, 5.0).reshape(1, 1, 1, 2, 2)
    got3 = TO.op_vjp_rows("maxpool2d", {}, (torch.from_numpy(x3),),
                          POOLS["3x3s2p1"], torch.from_numpy(g3))[0].numpy()
    np.testing.assert_array_equal(got3, _jax_rows_vjp(x3, g3,
                                                      POOLS["3x3s2p1"]))
    assert got3.sum() == g3.sum()


@pytest.mark.parametrize("pool", sorted(POOLS))
def test_rows_maxpool_bfloat16_against_float32(pool):
    """The bfloat16 sweep's vjp: the same routing as float32 (the capture
    holds small integers, exact in bfloat16), the sums within bfloat16
    rounding of the float32 result."""
    attrs = POOLS[pool]
    rng = np.random.RandomState(4)
    x = torch.from_numpy(_tied_input(rng, (2, 4, 29, 29))).float()
    y = TO.maxpool2d({}, (x,), **attrs)
    g = torch.randn((5,) + tuple(y.shape),
                    generator=torch.Generator().manual_seed(0))
    gb = g.to(torch.bfloat16)
    want = TO.op_vjp_rows("maxpool2d", {}, (x,), attrs, gb.float())[0]
    got = TO.op_vjp_rows("maxpool2d", {}, (x.to(torch.bfloat16),), attrs,
                         gb)[0]
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want.numpy(), rtol=0,
                               atol=4 * 2.0 ** -8 * float(g.abs().max()))


def test_rows_maxpool_has_no_scatter():
    """The rule is written without an accumulating scatter (the source of
    run-to-run differences on a card)."""
    import inspect

    src = inspect.getsource(TO._rows_maxpool2d)
    for name in ("scatter_add", "index_add", "index_put", "put_("):
        assert name not in src


def _strise(**kw):
    base = dict(probe=np.full((224, 224, 3), 128, np.uint8),
                refs=[np.zeros((224, 224, 3), np.uint8)],
                gallery=[np.ones((224, 224, 3), np.uint8)],
                black_box_fn=lambda p, g: np.zeros((len(p), len(g))),
                prior_type="uniform", num_masks=70, num_mask_elements=2,
                device="cpu")
    base.update(kw)
    return STRise(**base)


def _expected_draw(seed, n, scale=12, elements=2):
    """The draw of a CPU generator made here: uniform noise for the grids
    first, then the shifts."""
    gen = torch.Generator().manual_seed(seed)
    probs = TM.prior_to_grid(torch.ones((224, 224)), scale, "uniform")
    u = torch.rand((n, probs.numel()), generator=gen)
    tiny = torch.finfo(torch.float32).tiny
    noise = -torch.log(-torch.log(torch.clamp(u, min=tiny)))
    grids = TM.sparse_grids_from_noise(probs, noise, elements)
    shifts = torch.randint(0, scale, (n, 2), generator=gen,
                           dtype=torch.int32)
    return grids, shifts


@pytest.mark.parametrize("seed", [0, 1])
def test_strise_draw_is_a_cpu_generator_draw(seed):
    """STRise(seed=s)'s grids and shifts are those of a CPU generator
    seeded with s, whatever the batch size and whether or not the scorer
    uses the fused blend; the materialized masks are those grids and
    shifts upsampled."""
    grids, shifts = _expected_draw(seed, 70)
    masks = TM.upsample_shift_masks_static(grids, shifts, (224, 224), 12)
    for kw in (dict(use_pallas_blend=True, batch_size=64),
               dict(use_pallas_blend=True, batch_size=16)):
        st = _strise(seed=seed, **kw)
        st.uniform_prior()
        st.generate_masks()
        np.testing.assert_array_equal(st._grids_dev.numpy(), grids.numpy())
        np.testing.assert_array_equal(st._shifts_dev.numpy(),
                                      shifts.numpy())
        np.testing.assert_array_equal(st.masks, masks.numpy())
    for bs in (64, 16):
        st = _strise(seed=seed, use_pallas_blend=False, batch_size=bs)
        st.uniform_prior()
        st.generate_masks()
        assert st._grids_dev is None
        np.testing.assert_array_equal(st.masks, masks.numpy())
    other = _strise(seed=seed + 2)
    other.uniform_prior()
    other.generate_masks()
    assert not np.array_equal(other.masks, masks.numpy())


def test_uniform_prior_grid_is_the_hosts():
    """The uniform prior lies on the host, and make_masks computes the
    sampling grid where the prior lies, then draws on ``device``: the
    masks equal those drawn wholly on the host (whose percentile clip
    keeps the cells that the host's rounding left at the top)."""
    st = _strise(seed=3)
    st.uniform_prior()
    assert st.prior.device.type == "cpu"
    prior = torch.ones((224, 224))
    got = TM.make_masks(torch.Generator().manual_seed(3), prior, 8, 12, 2,
                        prior_type="uniform", device="cpu")
    grids, shifts = _expected_draw(3, 8)
    want = TM.upsample_shift_masks_static(grids, shifts, (224, 224), 12)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
