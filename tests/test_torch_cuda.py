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


def _reduced_mix_whitebox():
    """ResNet-101 at full widths with one block a stage, the numpy init
    of seed 2, on the card, bfloat16 sweep; two probes and the unit-normed
    mate/nonmate encodings."""
    from xfr_torch.ebp.engine import Whitebox, WhiteboxNetwork
    from xfr_torch.models import common
    from xfr_torch.models import resnet101 as R101

    graph, shapes, enc = R101.build_resnet101(layers=(1, 1, 1, 1))
    net = WhiteboxNetwork(
        graph, common.params_to(common.init_params(shapes, seed=2), "cuda"),
        encode_tensor=enc, classifier_pname="fc2", num_classes=65359)
    wb = Whitebox(net, ebp_version=6, ebp_subtree_mode="norelu",
                  wsebp_dtype=torch.bfloat16)
    rng = np.random.RandomState(0)
    x = torch.as_tensor(rng.rand(6, 3, 224, 224) * 50, dtype=torch.float32,
                        device="cuda")
    em, en = (e / e.norm() for e in (wb.encode(x[2:4]).mean(0),
                                     wb.encode(x[4:]).mean(0)))
    return wb, x[:2], em, en


def _mix(wb, probes, em, en):
    """The 4-map mix (mean-EBP, contrastive, truncated-contrastive,
    weighted-subtree top-32) as bench.py runs it: {name: [maps]}."""
    B = probes.shape[0]
    wb.net.reset_classifier()
    pooled, _ = wb._ebp_pooled_fn()(
        wb.net.params, probes,
        torch.ones((B, wb.net.num_classes()), device="cuda"))
    wb.set_triplet_classifier_batch((em / 2500.0).expand(B, -1),
                                    (en / 2500.0).expand(B, -1))
    contr, trunc = wb.contrastive_ebp_batch_both(probes, 20)
    wb.set_triplet_classifier_batch(em.expand(B, -1), en.expand(B, -1))
    ws = wb.weighted_subtree_ebp_batch(probes, topk=32,
                                       subtree_mode="norelu")
    return {"mean_ebp": list(pooled.cpu().numpy()), "contrastive": contr,
            "truncated_contrastive": trunc,
            "weighted_subtree": [r[0] for r in ws],
            "subtrees": [np.asarray(r[3]) for r in ws]}


@pytest.mark.cuda
def test_mix_is_bit_repeatable_on_card():
    """The mix on reduced-depth ResNet-101 twice on the same inputs: every
    map and every selected subtree bit for bit the same (the max-pool vjp
    sums in a fixed order, cuDNN runs deterministic algorithms)."""
    _need_card()
    wb, probes, em, en = _reduced_mix_whitebox()
    first = _mix(wb, probes, em, en)
    second = _mix(wb, probes, em, en)
    for name, maps in first.items():
        assert len(maps) == 2
        for a, b in zip(maps, second[name]):
            assert np.isfinite(a).all(), name
            np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.cuda
def test_rows_maxpool_on_card_matches_cpu():
    """The row-batched max-pool vjp of ResNet-101's stem pool (3x3,
    stride 2, padding 1) on a [2, 64, 112, 112] capture with ties, 4 rows:
    the same on two card runs, and within float32 rounding of the CPU's
    (the same sums in the same order)."""
    from xfr_torch import ops as TO

    _need_card()
    rng = np.random.RandomState(1)
    x = torch.from_numpy(rng.randint(0, 3, (2, 64, 112, 112))
                         .astype(np.float32))
    g = torch.from_numpy(rng.randn(4, 2, 64, 56, 56).astype(np.float32))
    attrs = dict(kernel=3, stride=2, padding=1)
    want = TO.op_vjp_rows("maxpool2d", {}, (x,), attrs, g)[0].numpy()
    got = [TO.op_vjp_rows("maxpool2d", {}, (x.cuda(),), attrs,
                          g.cuda())[0].cpu().numpy() for _ in range(2)]
    np.testing.assert_array_equal(got[0], got[1])
    np.testing.assert_allclose(got[0], want, rtol=0,
                               atol=4 * 2.0 ** -23 * np.abs(want).max())
