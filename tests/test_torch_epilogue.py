"""The fused elementwise epilogue of keep-limited clean forwards
(``xfr_torch.epilogue``, ``interpreter.forward_clean``).

On the CPU: the plan's chains on the built graphs (ResNet-101, SENet-50-256,
LightCNN-29 v2 and the others), full forwards and autograd left op by op,
the planned forward equal to the op-by-op forward bit for bit in float32
and float64 on both dense layouts, the wrapper's output laid out as the
eager chain lays it out, the wrapper's refusals, and the BatchNorm and
launch counters.  On a card (marker ``cuda``, skipped without one): the
kernel against its plain version bit for bit for every stage combination
at the main path's shapes in both layouts, with the eager chain's output
strides; captured ResNet-101 and SENet-50-256 encodes, and the planned
encodes of ResNet-50-128, VGG-16 and LightCNN-29 v2, equal to the
op-by-op encode bit for bit; the launch counter.

This file imports neither JAX nor the JAX package, so on a machine with a
card it runs without the repository's JAX test setup:

    python -m pytest tests/test_torch_epilogue.py --noconftest -q
"""

import itertools
from collections import Counter

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from torch_fixtures import eager_replay  # noqa: F401
from xfr_torch import epilogue as EP
from xfr_torch import replay as R
from xfr_torch.detection import network as DN
from xfr_torch.ebp import engine as E
from xfr_torch.ebp import interpreter as I
from xfr_torch.models import common
from xfr_torch.models import lightcnn as LCNN
from xfr_torch.models import resnet101 as R101
from xfr_torch.models import vggface as VGG
from xfr_torch.models import vggface2 as V2
from xfr_torch.utils import profiling
from xfr_torch.utils.device import precision_scope


def _build(name, full_depth=False):
    """(graph, param shapes, kept tensor, [C, H, W] input) of a built
    graph, one block a stage unless ``full_depth``."""
    depth = {} if full_depth else {"layers": (1, 1, 1, 1)}
    if name == "resnet101":
        g, shapes, enc = R101.build_resnet101(num_classes=16, **depth)
        return g, shapes, enc, (3, 224, 224)
    if name in ("senet50_256", "resnet50_128"):
        build = getattr(V2, "build_" + name)
        g, shapes, enc = build(num_classes=16, **depth)
        return g, shapes, enc, (3, 224, 224)
    if name == "lightcnn29":
        g, shapes, enc = LCNN.build_lightcnn29v2(num_classes=16, **depth)
        return g, shapes, enc, (1, 128, 128)
    if name == "vgg16":
        g, shapes, enc = VGG.build_vgg16(num_classes=16, cfg=((1, 8), (2, 16)),
                                         input_hw=32, fc_dim=32)
        return g, shapes, enc, (3, 32, 32)
    if name == "frcnn_trunk":
        g, shapes = DN.build_trunk()
        return g, shapes, g.output_id, (3, 64, 80)
    raise KeyError(name)


def _stages(chain):
    return tuple(s for s, on in (
        ("bias", chain.conv is not None), ("bn", chain.bn is not None),
        ("gate", chain.gate is not None),
        ("add", chain.residual is not None), ("relu", chain.relu)) if on)


@pytest.mark.parametrize("name,chains,kinds", [
    ("resnet101", 100, {("bias", "bn", "relu"): 67,
                        ("bias", "bn", "add", "relu"): 33}),
    ("senet50_256", 85, {("bn", "relu"): 33, ("bn",): 20,
                         ("gate", "add", "relu"): 16,
                         ("bias", "relu"): 16}),
    ("lightcnn29", 0, {}),
])
def test_plan_covers_every_batchnorm(name, chains, kinds):
    """ResNet-101: 100 chains over its 100 BatchNorms, the 33 block ends
    with the add; SENet-50-256: its 53 BatchNorms, each block's gate ->
    add -> ReLU, each squeeze-excite 1x1_down's bias -> ReLU, the
    1x1_increase BatchNorm alone (the pool and the gate read it) and the
    1x1_proj's; LightCNN-29 v2: no chain (its lone conv bias before
    pair_max stays as it is)."""
    g, shapes, enc, _ = _build(name, full_depth=True)
    plan = EP.plan(g, (enc,), EP.biased(g, shapes))
    assert len(plan.chains) == chains
    assert dict(Counter(map(_stages, plan.chains))) == kinds
    assert plan.n_bn == plan.n_bn_fused == g.n_bn
    assert g.n_bn == {"resnet101": 100, "senet50_256": 53,
                      "lightcnn29": 0}[name]
    fused = [t for c in plan.chains for t in c.nodes]
    assert len(fused) == len(set(fused))  # no node in two chains


def test_no_chain_crosses_a_kept_tensor_or_a_second_reader():
    """A kept tensor ends its chain; a chain never takes a node another
    chain holds, and fuses no tensor with a second reader."""
    g, shapes, enc, _ = _build("resnet101")
    bn1 = next(n.out for n in g.nodes if n.op == "batchnorm2d")
    biased = EP.biased(g, shapes)
    plan = EP.plan(g, (enc, bn1), biased)
    (stem,) = [c for c in plan.chains if c.out == bn1]
    assert _stages(stem) == ("bias", "bn")
    relu = [c for c in plan.chains if c.x == bn1]
    assert relu == []  # the ReLU alone is no chain
    for c in EP.plan(g, (enc,), biased).chains:
        for a, b in zip(c.nodes, c.nodes[1:]):
            assert g.readers(g.nodes[a].out) == (b,)
    assert EP.plan(g, (enc,), biased, fuse=False).chains == ()


@pytest.mark.parametrize("name", ["resnet101", "senet50_256", "resnet50_128",
                                  "lightcnn29", "vgg16", "frcnn_trunk"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("layout", ["nchw", "channels_last"])
def test_planned_forward_equals_op_by_op(name, dtype, layout, monkeypatch):
    """The planned keep-limited forward gives the op-by-op forward's
    kept tensors bit for bit, running one epilogue a chain."""
    g, shapes, enc, chw = _build(name)
    params = common.init_params(shapes, seed=1, dtype=dtype)
    x = torch.randn((2,) + chw, generator=torch.Generator().manual_seed(2),
                    dtype=dtype) * 50
    if layout == "channels_last":
        x = x.contiguous(memory_format=torch.channels_last)
    calls = []
    real = EP.fused_epilogue
    monkeypatch.setattr(EP, "fused_epilogue",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    keep = (enc, g.output_id)
    got = I.forward_clean(g, params, x, keep=keep)
    want = I.forward_values(g, params, x, keep=keep)
    plan = I.clean_plan(g, params, keep, x)
    assert len(calls) == len(plan.chains)
    for t in range(g.n_tensors):
        if t in keep:
            assert torch.equal(got[t], want[t])
            assert got[t].stride() == want[t].stride()
        else:
            assert got[t] is None


def test_a_forward_that_stops_inside_a_chain_skips_it():
    """Keeping a downsample block's padded residual stops the forward
    before the block's conv3 -> bn3 -> add -> relu chain ends: the chain
    is not run, and the kept tensors are the op-by-op forward's."""
    g, shapes, enc, chw = _build("resnet101")
    params = common.init_params(shapes, seed=1)
    x = torch.randn((2,) + chw)
    pad = [n.out for n in g.nodes if n.op == "concat_zero_channels"][1]
    bn1 = next(n.out for n in g.nodes if n.op == "batchnorm2d")
    keep = (bn1, pad)
    plan = I.clean_plan(g, params, keep, x)
    reached = [a for kind, a in plan.steps if kind != "chain"]
    assert all(c.nodes[-1] <= max(reached) for k, c in plan.steps
               if k == "chain")
    got = I.forward_clean(g, params, x, keep=keep)
    want = I.forward_values(g, params, x, keep=keep)
    for t in keep:
        assert torch.equal(got[t], want[t])


def test_full_forwards_and_autograd_stay_op_by_op(monkeypatch):
    """``forward_clean(keep=None)`` (the EBP walks' pass 1) and
    ``forward_values`` (training, under autograd) run no epilogue; a
    card's forward of another dtype than float32 forms no chain."""
    g, shapes, enc, chw = _build("resnet101")
    params = common.init_params(shapes, seed=1)
    x = torch.randn((1,) + chw)

    def refuse(*a, **k):
        raise AssertionError("a fused epilogue ran")

    monkeypatch.setattr(EP, "fused_epilogue", refuse)
    I.forward_clean(g, params, x)
    with torch.enable_grad():
        p = {k: {kk: v.clone().requires_grad_(True) for kk, v in d.items()}
             for k, d in params.items()}
        y = I.forward_values(g, p, x, keep=(enc,))[enc]
        assert y.requires_grad
    assert not EP.engages(torch.empty(1, dtype=torch.float64, device="meta"))
    assert EP.engages(torch.empty(1, dtype=torch.float32, device="meta"))
    assert EP.engages(torch.empty(1, dtype=torch.float64))


def _layout(t, nhwc):
    return t.contiguous(memory_format=torch.channels_last if nhwc
                        else torch.contiguous_format)


STRIDE_SHAPES = [(2, 4, 3, 5), (1, 4, 3, 5), (2, 4, 1, 1), (2, 1, 3, 5),
                 (1, 4, 1, 1), (2, 4, 1, 5), (2, 4, 3, 4)]


@pytest.mark.parametrize("shape", STRIDE_SHAPES,
                         ids=["x".join(map(str, s)) for s in STRIDE_SHAPES])
def test_eager_strides_match_the_eager_chain(shape):
    """The kernel's output, laid out as x (``torch.empty_like``), has the
    strides of the eager chain on the CPU (whose TensorIterator is the
    card's) for every stage combination, both dense layouts of x with the
    residual laid out alike, and both operand orders; size-1 dims tie
    their strides.  A non-dense x, or a residual laid out otherwise,
    is refused."""
    g = torch.Generator().manual_seed(0)
    n, c = shape[:2]
    checked = 0
    for i, (nhwc, combo) in enumerate(itertools.product((False, True),
                                                        COMBOS)):
        x = _layout(torch.randn(shape, generator=g), nhwc)
        kw = {"relu": "relu" in combo}
        if "bias" in combo:
            kw["bias"] = torch.randn(c, generator=g)
        if "bn" in combo:
            kw["bn"] = {k: torch.rand(c, generator=g) + 0.5
                        for k in EP._BN_KEYS}
        if "gate" in combo:
            kw["gate"] = torch.randn((n, c, 1, 1), generator=g)
            kw["gate_first"] = i % 3 != 0
        if "add" in combo:
            kw["residual"] = _layout(torch.randn(shape, generator=g), nhwc)
            kw["residual_first"] = i % 5 == 0
        want = EP.fused_epilogue_reference(x, **kw)
        assert torch.empty_like(x).stride() == want.stride(), (nhwc, combo)
        assert EP.fused_epilogue(x, **kw).stride() == want.stride()
        checked += 1
    assert checked == 2 * 31
    with pytest.raises(ValueError, match="dense"):
        EP.fused_epilogue(torch.randn(n, c, shape[2], 2 * shape[3])[..., ::2],
                          relu=True)
    x = torch.randn(shape, generator=g)
    last = _layout(x, True)
    if not last.is_contiguous():  # the two layouts differ at this shape
        with pytest.raises(ValueError, match="laid out as x"):
            EP.fused_epilogue(last, residual=x, relu=True)


def test_the_wrapper_refuses_what_the_kernel_does_not_take():
    x = torch.zeros(2, 4, 3, 3)
    with pytest.raises(ValueError, match="gate"):
        EP.fused_epilogue(x, gate=torch.zeros(1, 4, 1, 1))
    with pytest.raises(ValueError, match="residual"):
        EP.fused_epilogue(x, residual=torch.zeros(2, 4, 1, 3))
    with pytest.raises(ValueError, match="laid out as x"):
        EP.fused_epilogue(x, residual=torch.zeros(2, 4, 3, 3).contiguous(
            memory_format=torch.channels_last))
    with pytest.raises(ValueError, match="laid out as x"):
        EP.fused_epilogue(x.contiguous(memory_format=torch.channels_last),
                          residual=torch.zeros(2, 4, 3, 3))
    with pytest.raises(ValueError, match="dense"):
        EP.fused_epilogue(torch.zeros(2, 4, 3, 6)[..., ::2], relu=True)
    with pytest.raises(ValueError, match="per-channel"):
        EP.fused_epilogue(x, bias=torch.zeros(3))
    with pytest.raises(ValueError, match="contiguous"):
        EP.fused_epilogue(x, bias=torch.zeros(8)[::2])
    with pytest.raises(ValueError, match="N, C, H, W"):
        EP.fused_epilogue(torch.zeros(2, 4), relu=True)
    with pytest.raises(ValueError, match="unsupported device"):
        EP.fused_epilogue(torch.zeros(2, 4, 3, 3, device="meta"), relu=True)


def _counted(fn):
    before = profiling.counters()
    with profile(activities=[ProfilerActivity.CPU]):
        fn()
    return {k: v - before.get(k, 0) for k, v in profiling.counters().items()
            if v != before.get(k, 0)}


def _replayed_encode(graph, params, enc, x):
    """The encode of ``x`` through ``replay.run``, as STRise's chunks run
    it."""
    def encode(x):
        e = I.forward_clean(graph, params, x, keep=(enc,))[enc]
        return e.reshape(x.shape[0], -1)

    return R.run(encode, x, graph, "encode", I.param_ids(graph, params, enc))


def test_batchnorm_rows_are_counted(request):
    """Under a profiler a keep-limited forward counts its BatchNorm nodes
    a row (``xfr.enc.bn_rows``), all fused (``xfr.enc.bn_rows_fused``);
    a full forward counts them unfused; LightCNN counts none; a replay
    counts what its capture's forward counted; nothing counts without a
    profiler."""
    g, shapes, enc, chw = _build("senet50_256")
    params = common.init_params(shapes, seed=1)
    x = torch.randn((3,) + chw)
    n_bn = g.n_bn
    assert n_bn == 17
    assert _counted(lambda: I.forward_clean(g, params, x, keep=(enc,))) == {
        "xfr.enc.se_gates": 4 * 3, "xfr.enc.bn_rows": n_bn * 3,
        "xfr.enc.bn_rows_fused": n_bn * 3}
    assert _counted(lambda: I.forward_clean(g, params, x)) == {
        "xfr.enc.se_gates": 4 * 3, "xfr.enc.bn_rows": n_bn * 3}
    lg, lshapes, lenc, lchw = _build("lightcnn29")
    lx = torch.randn((2,) + lchw)
    assert _counted(lambda: I.forward_clean(
        lg, common.init_params(lshapes, seed=1), lx, keep=(lenc,))) == {}

    request.getfixturevalue("eager_replay")
    _replayed_encode(g, params, enc, x)  # captures
    assert _counted(lambda: _replayed_encode(g, params, enc, x)) == {
        "xfr.enc.se_gates": 4 * 3, "xfr.enc.bn_rows": n_bn * 3,
        "xfr.enc.bn_rows_fused": n_bn * 3}
    before = profiling.counters()
    I.forward_clean(g, params, x, keep=(enc,))
    _replayed_encode(g, params, enc, x)
    assert profiling.counters() == before


def test_captured_encode_counts_its_batchnorm_rows(eager_replay):
    """A captured encode records the BatchNorm rows its forward counts
    (all fused), and the prior walk's graph its unfused BatchNorm rows."""
    g, shapes, enc, chw = _build("resnet101")
    net = E.WhiteboxNetwork(g, common.init_params(shapes, seed=1),
                            encode_tensor=enc, classifier_pname="fc2",
                            num_classes=16)
    x = torch.randn((2,) + chw)
    _replayed_encode(g, net.params, enc, x)
    E.Whitebox(net).uniform_pooled_ebp(net.params, x[:1])
    recorded = {k.tag if k.tag == "encode" else k.tag[0]: c.counts
                for k, c in R.graphs(g).items()}
    assert g.n_bn == 13
    assert recorded == {
        "encode": {"xfr.enc.bn_rows": 13 * 2, "xfr.enc.bn_rows_fused": 13 * 2},
        "pooled_ebp": {"xfr.enc.bn_rows": 13}}


class _Owner:
    """An owner of ``replay.run``'s graphs."""


def test_a_replay_makes_what_its_capture_counted(eager_replay):
    """While a graph is captured, its function's counts and launches are
    recorded and not made, under a profiler too; each replay then makes
    exactly what was recorded: the counts while a profiler records, the
    launches always.  The capture's eager warm-up counts as an eager
    call."""
    def fn(x):
        profiling.count("xfr.enc.bn_rows", 7 * x.shape[0])
        profiling.launched(EP.fused_epilogue)
        return x + 1

    x = torch.zeros((3, 2))
    launches = EP.fused_epilogue.launches
    with profiling.recording() as recorded:
        assert _counted(lambda: fn(x)) == {}
    assert recorded == {"xfr.enc.bn_rows": 21, EP.fused_epilogue: 1}
    assert EP.fused_epilogue.launches == launches

    owner = _Owner()
    assert _counted(lambda: R.run(fn, x, owner, "t", ())) == {
        "xfr.enc.bn_rows": 2 * 21}  # the warm-up and the first replay
    (captured,) = R.graphs(owner).values()
    assert captured.counts == recorded
    assert EP.fused_epilogue.launches == launches + 2
    for n in (1, 2):
        got = _counted(lambda: R.run(fn, x, owner, "t", ()))
        assert got == {"xfr.enc.bn_rows": 21}
        assert EP.fused_epilogue.launches == launches + 2 + n
    before = profiling.counters()
    assert torch.equal(R.run(fn, x + 1, owner, "t", ()), x + 2)
    assert profiling.counters() == before
    assert EP.fused_epilogue.launches == launches + 5


# ---------------------------------------------------------------------------
# On a card
# ---------------------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU form")


# (C, H, W) of ResNet-101's and SENet-50-256's epilogues at 224x224, and
# the squeeze-excite branch's [N, C/16, 1, 1]
MAIN_SHAPES = [(64, 112, 112), (64, 56, 56), (256, 56, 56), (128, 28, 28),
               (512, 28, 28), (256, 14, 14), (1024, 14, 14), (512, 7, 7),
               (2048, 7, 7), (16, 1, 1), (128, 1, 1)]
COMBOS = [c for n in range(1, 6) for c in itertools.combinations(
    ("bias", "bn", "gate", "add", "relu"), n)]


def _chain_args(shape, combo, nhwc, seed, device="cuda"):
    """Inputs of one chain at [N, C, H, W] ``shape`` with NaNs, infinities
    and signed zeros among the values."""
    gen = torch.Generator(device=device).manual_seed(seed)
    N, C = shape[:2]
    x = torch.randn(shape, generator=gen, device=device) * 3
    flat = x.view(-1)
    flat[::997] = 0.0
    flat[1::1009] = -0.0
    flat[2::4099] = float("nan")
    flat[3::8191] = float("inf")
    x = _layout(x, nhwc)
    kw = {}
    if "bias" in combo:
        kw["bias"] = torch.randn(C, generator=gen, device=device)
    if "bn" in combo:
        kw["bn"] = {"mean": torch.randn(C, generator=gen, device=device),
                    "var": torch.rand(C, generator=gen, device=device) + 0.1,
                    "gamma": torch.randn(C, generator=gen, device=device),
                    "beta": torch.randn(C, generator=gen, device=device)}
        kw["eps"] = 1e-5
    if "gate" in combo:
        kw["gate"] = torch.rand((N, C, 1, 1), generator=gen, device=device)
    if "add" in combo:
        kw["residual"] = _layout(torch.randn(shape, generator=gen,
                                             device=device), nhwc)
    kw["relu"] = "relu" in combo
    return x, kw


def _same_bits(a, b):
    return a.shape == b.shape and torch.equal(a.contiguous().view(
        torch.int32), b.contiguous().view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("nhwc", [False, True], ids=["nchw", "nhwc"])
def test_kernel_equals_its_plain_version_on_card(nhwc):
    """Every stage combination at every main-path shape (8 rows), in
    both layouts: the same bits as the eager chain, NaN, infinity and
    the sign of zero included, and the eager chain's strides; the launch
    counter counts each call."""
    _card()
    before = EP.fused_epilogue.launches
    calls = 0
    for i, (shape, combo) in enumerate(itertools.product(MAIN_SHAPES,
                                                         COMBOS)):
        x, kw = _chain_args((8,) + shape, combo, nhwc, seed=i)
        got = EP.fused_epilogue(x, **kw)
        want = EP.fused_epilogue_reference(x, **kw)
        calls += 1
        assert _same_bits(got, want), (shape, combo)
        assert got.stride() == want.stride(), (shape, combo)
    assert EP.fused_epilogue.launches == before + calls


def _card_net(name):
    g, shapes, enc, chw = _build(name, full_depth=True)
    params = common.params_to(common.init_params(shapes, seed=4), "cuda")
    net = E.WhiteboxNetwork(g, params, encode_tensor=enc,
                            classifier_pname="fc2" if name == "resnet101"
                            else "fc1", num_classes=16)
    return net, chw


@pytest.mark.cuda
@pytest.mark.parametrize("name,precision,nhwc", [
    ("resnet101", "high", True), ("resnet101", "high", False),
    ("resnet101", None, False), ("senet50_256", "high", True)],
    ids=["r101-f32-nhwc", "r101-f32-nchw", "r101-tf32-nchw",
         "senet-f32-nhwc"])
def test_captured_encode_equals_the_op_by_op_encode_on_card(name, precision,
                                                            nhwc):
    """A 64-row encode at full depth, captured as a CUDA graph and
    replayed, and the planned eager encode, equal the op-by-op encode
    (``forward_values``) bit for bit; neither waits for the card."""
    _card()
    net, chw = _card_net(name)
    g, enc = net.graph, net.encode_tensor
    gen = torch.Generator(device="cuda").manual_seed(5)
    x = _layout(torch.randn((64,) + chw, generator=gen, device="cuda") * 50,
                nhwc)
    with precision_scope(precision):
        want = I.forward_values(g, net.params, x, keep=(enc,))[enc]
    want = want.reshape(64, -1)
    with precision_scope(precision):
        _replayed_encode(g, net.params, enc, x)  # captures
    (captured,) = R.graphs(g).values()
    launches = EP.fused_epilogue.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        with precision_scope(precision):
            got = _replayed_encode(g, net.params, enc, x).clone()
            eager = I.forward_clean(g, net.params, x, keep=(enc,))[enc]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    plan = I.clean_plan(g, net.params, (enc,), x)
    # one replay and one eager encode, each running every chain once
    assert captured.counts[EP.fused_epilogue] == len(plan.chains)
    assert EP.fused_epilogue.launches == launches + 2 * len(plan.chains)
    assert plan.n_bn_fused == g.n_bn
    assert _same_bits(got, want)
    assert _same_bits(eager.reshape(64, -1), want)


@pytest.mark.cuda
@pytest.mark.parametrize("name,precision", [
    ("resnet50_128", "high"), ("resnet50_128", None), ("vgg16", "high"),
    ("vgg16", None), ("lightcnn29", "high")])
@pytest.mark.parametrize("nhwc", [False, True], ids=["nchw", "nhwc"])
def test_every_matchers_planned_encode_equals_op_by_op_on_card(
        name, precision, nhwc):
    """The other matchers at full depth and their own input sizes (VGG-16's
    conv bias -> ReLU chains, ResNet-50-128's BatchNorm chains; LightCNN-29
    v2 has none), 16 rows: the planned encode equals the op-by-op encode
    bit for bit and runs one epilogue a chain."""
    _card()
    if name == "vgg16":
        g, shapes, enc = VGG.build_vgg16(num_classes=16)
        chw = (3, 224, 224)
    else:
        g, shapes, enc, chw = _build(name, full_depth=True)
    params = common.params_to(common.init_params(shapes, seed=4), "cuda")
    gen = torch.Generator(device="cuda").manual_seed(6)
    x = _layout(torch.randn((16,) + chw, generator=gen, device="cuda") * 50,
                nhwc)
    plan = I.clean_plan(g, params, (enc,), x)
    assert len(plan.chains) == {"resnet50_128": 53, "vgg16": 13,
                                "lightcnn29": 0}[name]
    launches = EP.fused_epilogue.launches
    with precision_scope(precision):
        want = I.forward_values(g, params, x, keep=(enc,))[enc]
        got = I.forward_clean(g, params, x, keep=(enc,))[enc]
    assert EP.fused_epilogue.launches == launches + len(plan.chains)
    assert _same_bits(got, want)
    assert got.stride() == want.stride()
