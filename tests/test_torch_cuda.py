"""The hand-written CUDA kernels: how they are built, and (on a card) each
against its plain PyTorch version.

The card tests carry the ``cuda`` marker and skip without a card.  This
file imports neither JAX nor the JAX package, so on a machine with a card
it runs without the repository's JAX test setup:

    python -m pytest tests/test_torch_cuda.py --noconftest -q
"""

import numpy as np
import pytest
import torch

from xfr_torch import kernels
from xfr_torch.blackbox import fused_blend as FB
from xfr_torch.blackbox import masks as TM

MEAN = np.array([122.782, 117.001, 104.298], np.float32)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU form")


def _card_inputs(n, size=224, scale=12, seed=2):
    """Main-path-shaped kernel inputs on the card: [n, 19, 19] grids,
    shifts in [0, scale), a 0..255 probe and its blur fill."""
    rng = np.random.RandomState(seed)
    g = -(-size // scale)
    grids = (rng.rand(n, g, g) > 0.2).astype(np.float32)
    shifts = rng.randint(0, scale, (n, 2)).astype(np.int32)
    probe = torch.from_numpy((rng.rand(size, size, 3) * 255)
                             .astype(np.float32))
    fill = TM.gaussian_blur(probe, 0.04 * size)
    return [torch.as_tensor(a).cuda() for a in
            (grids, shifts, probe, fill, MEAN)]


@pytest.mark.parametrize("missing", [True, False],
                         ids=["nvcc-missing", "nvcc-fails"])
def test_build_raises_without_a_library(tmp_path, monkeypatch, missing):
    """A missing nvcc or a failed build raises and leaves no library."""
    monkeypatch.setattr(kernels, "BUILD_DIR", str(tmp_path))
    if missing:
        monkeypatch.setattr(kernels.shutil, "which", lambda _: None)
        monkeypatch.setattr(kernels, "NVCC_DEFAULT",
                            str(tmp_path / "no-nvcc"))
        match = "nvcc not found"
    else:
        monkeypatch.setattr(kernels, "_nvcc", lambda: "/usr/bin/false")
        match = "nvcc failed to build fused_blend.cu"
    with pytest.raises(RuntimeError, match=match):
        kernels.load.__wrapped__("fused_blend")
    assert not any(p.suffix == ".so" for p in tmp_path.iterdir())


@pytest.mark.cuda
def test_kernel_matches_plain_version_on_card():
    """The CUDA kernel against its plain version at the main path's shapes,
    rtol 1e-4 / atol 1e-3 on 0..255 pixels (a few float32 steps of the
    mask weight times |probe - fill|)."""
    _need_card()
    t = _card_inputs(64)
    got = FB.fused_mask_blend_preprocess(*t, mask_scale=12)
    want = FB.fused_mask_blend_preprocess_reference(*t, mask_scale=12)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=1e-4, atol=1e-3)


@pytest.mark.cuda
def test_kernel_counts_launches_and_refuses_bad_inputs_on_card():
    """One launch adds one to the count; a tensor of another type or
    layout raises instead of falling back to the plain version."""
    _need_card()
    t = _card_inputs(3)
    before = FB.fused_mask_blend_preprocess.launches
    FB.fused_mask_blend_preprocess(*t, mask_scale=12)
    assert FB.fused_mask_blend_preprocess.launches == before + 1
    with pytest.raises(TypeError, match="float32"):
        FB.fused_mask_blend_preprocess(t[0].double(), *t[1:], mask_scale=12)
    with pytest.raises(ValueError, match="contiguous"):
        FB.fused_mask_blend_preprocess(t[0].transpose(1, 2), *t[1:],
                                       mask_scale=12)
    with pytest.raises(ValueError, match="expected"):
        FB.fused_mask_blend_preprocess(t[0], t[1].cpu(), *t[2:],
                                       mask_scale=12)
    assert FB.fused_mask_blend_preprocess.launches == before + 1
