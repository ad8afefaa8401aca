"""The monotone blend+encode steps' captured encode (``replay.run``).

On the CPU the steps stay eager; the staged form of a step (the blend
written into the static input, the encode replayed, the static output
copied into the step's block) runs there with an eager stand-in for the
CUDA graph (``torch_fixtures.eager_replay``), and gives the eager loop's
embeddings bit for bit.  The graph cache follows the parameters'
addresses and empties on a device move and on ``clear()``.  On a card (marker ``cuda``, skipped without
one) the graphed steps of two groups in flight equal the eager loop's bit
for bit at full depth, and a parameter swap captures again.

This file imports neither JAX nor the JAX package, so on a machine with a
card it runs without the repository's JAX test setup:

    python -m pytest tests/test_torch_step_graphs.py --noconftest -q
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from torch_fixtures import eager_replay  # noqa: F401
from xfr_torch import replay as R
from xfr_torch.ebp import engine as E
from xfr_torch.models import common
from xfr_torch.models import lightcnn as LCNN
from xfr_torch.models import resnet101 as R101
from xfr_torch.utils import profiling
from xfr_torch.utils.device import precision_scope

MATCHERS = ["resnet101", "lightcnn29"]
REDUCED = (1, 1, 1, 1)


def _whitebox(name, device="cpu", full_depth=False, seed=3):
    """(Whitebox, [C, H, W]) of a matcher at published widths, one block a
    stage unless ``full_depth``, the numpy init of ``seed``, on
    ``device``."""
    depth = {} if full_depth else {"layers": REDUCED}
    if name == "resnet101":
        graph, shapes, enc = R101.build_resnet101(num_classes=16, **depth)
        chw = (3, 224, 224)
    else:
        graph, shapes, enc = LCNN.build_lightcnn29v2(num_classes=16, **depth)
        chw = (1, 128, 128)
    params = common.params_to(common.init_params(shapes, seed=seed), device)
    net = E.WhiteboxNetwork(graph, params, encode_tensor=enc,
                            classifier_pname="fc2", num_classes=16)
    return E.Whitebox(net), chw


def _group(chw, M, T, seed):
    """A probe, its twin and M enter-count planes of T thresholds."""
    rng = np.random.RandomState(seed)
    orig = (rng.rand(*chw) * 50).astype(np.float32)
    inp = orig + (rng.rand(*chw) * 30).astype(np.float32)
    counts = rng.randint(0, T + 1, (M, chw[1] * chw[2])).astype(np.uint8)
    return orig, inp, counts


def _launch(wb, group, T):
    return wb.launch_blend_embeddings_counts_multi(*group, T, norm=False)


def _counted(fn):
    """(fn(), the counters it added) while a CPU profiler records."""
    before = profiling.counters()
    with profile(activities=[ProfilerActivity.CPU]):
        out = fn()
    return out, {k: v - before.get(k, 0)
                 for k, v in profiling.counters().items()
                 if v != before.get(k, 0)}


@pytest.mark.parametrize("name", MATCHERS)
def test_staged_steps_equal_the_eager_loop(name, request):
    """Reduced-depth matchers, M = 4 maps of T = 10 thresholds in steps
    of 4 rows (3 steps a map, 2 rows past T), two groups launched before
    either finishes: the staged steps give the eager loop's embeddings
    bit for bit, with one capture and a replay a step."""
    wb, chw = _whitebox(name)
    wb.blend_batch = wb.batch_size = 4
    T, groups = 10, [_group(chw, 4, 10, seed) for seed in (0, 1)]
    want = [_launch(wb, g, T)() for g in groups]
    assert R.graphs(wb.net.graph) == {}

    request.getfixturevalue("eager_replay")

    def staged():
        fins = [_launch(wb, g, T) for g in groups]
        return [f() for f in fins]

    got, counted = _counted(staged)
    for g, w in zip(got, want):
        assert g.shape == (4, T, w.shape[-1])
        np.testing.assert_array_equal(g, w)
    # the capture's eager warm-up and each replay count their BatchNorm
    # nodes (ResNet-101's 13 at this depth, all in a fused epilogue;
    # LightCNN has none); the capture itself counts nothing
    bn = {k: wb.net.graph.n_bn * 4 * (2 * 12 + 1)
          for k in ("xfr.enc.bn_rows", "xfr.enc.bn_rows_fused")
          if wb.net.graph.n_bn}
    assert counted == {"xfr.eval.steps": 2 * 12,
                       "xfr.eval.rows_encoded": 2 * 48,
                       "xfr.eval.rows_needed": 2 * 40,
                       "xfr.eval.graph_replays": 2 * 12, **bn}
    assert len(R.graphs(wb.net.graph)) == 1


def test_cpu_steps_stay_eager_and_count_no_replays():
    """Without a card nothing is captured: the counters are those of the
    eager loop, and the graph counters stay at 0."""
    wb, chw = _whitebox("lightcnn29")
    wb.blend_batch = wb.batch_size = 4
    out, counted = _counted(lambda: _launch(wb, _group(chw, 2, 5, 2), 5)())
    assert out.shape == (2, 5, 256) and np.isfinite(out).all()
    assert counted == {"xfr.eval.steps": 4, "xfr.eval.rows_encoded": 16,
                       "xfr.eval.rows_needed": 10}
    assert R.graphs(wb.net.graph) == {}


def test_graph_cache_follows_params_and_device(eager_replay, monkeypatch):
    """One graph per input shape under one set of parameter tensors;
    replacing them (new addresses, other values) captures again and drops
    the old set's graphs; a device move (``_apply``) and ``clear()``
    empty the cache."""
    wb, chw = _whitebox("lightcnn29")
    net = wb.net

    def graphs():
        return R.graphs(net.graph)

    wb.blend_batch = wb.batch_size = 4
    group = _group(chw, 1, 3, 4)
    with precision_scope(None):
        tf32 = R.precision()

    _launch(wb, group, 3)()
    (key, first), = graphs().items()
    assert (key.shape, key.dtype, key.device, key.precision, key.tag) == (
        (4, 1, 128, 128), torch.float32, torch.device("cpu"), tf32,
        "eval_step")
    _launch(wb, group, 3)()
    assert graphs() == {key: first}

    wb.blend_batch = wb.batch_size = 2  # another step shape, same params
    _launch(wb, group, 3)()
    assert len(graphs()) == 2

    old = net.params
    net.params = {k: {kk: vv * 1.5 for kk, vv in p.items()}
                  for k, p in old.items()}
    swapped = _launch(wb, group, 3)()
    (key2, graph2), = graphs().items()
    assert (key2.shape, key2.dtype, key2.device, key2.precision) == (
        (2, 1, 128, 128), torch.float32, torch.device("cpu"), tf32)
    assert key2.params != key.params and graph2 is not first
    monkeypatch.setattr(R, "engages", lambda device: False)
    np.testing.assert_array_equal(swapped, _launch(wb, group, 3)())

    net.to("cpu")
    assert graphs() == {}
    monkeypatch.setattr(R, "engages", lambda device: True)
    _launch(wb, group, 3)()
    assert len(graphs()) == 1
    net.clear()
    assert graphs() == {}


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs exist only there")


@pytest.mark.cuda
@pytest.mark.parametrize("name", MATCHERS)
def test_graphed_groups_in_flight_equal_the_eager_loop_on_card(
        name, monkeypatch):
    """Full depth, the eval's shapes (M = 4 maps of T = 101 thresholds,
    16 steps of 32 rows): two groups launched back to back, each
    ``finish()`` only after the second launch, give the eager loop's
    embeddings bit for bit; the launches wait for nothing."""
    _need_card()
    wb, chw = _whitebox(name, device="cuda", full_depth=True)
    T, groups = 101, [_group(chw, 4, 101, seed) for seed in (5, 6)]
    with monkeypatch.context() as m:
        m.setattr(R, "engages", lambda device: False)
        want = [_launch(wb, g, T)() for g in groups]
    assert R.graphs(wb.net.graph) == {}
    _launch(wb, groups[0], T)()  # captures
    (key, graph), = R.graphs(wb.net.graph).items()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fins = [_launch(wb, g, T) for g in groups]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    got = [f() for f in fins]
    assert R.graphs(wb.net.graph) == {key: graph}
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.cuda
def test_param_swap_recaptures_on_card(monkeypatch):
    """Parameters replaced by others (the old ones kept alive, so a stale
    graph would still read them): the next launch captures again and
    gives the new parameters' eager embeddings."""
    _need_card()
    wb, chw = _whitebox("resnet101", device="cuda")
    T, group = 101, _group(chw, 2, 101, 7)
    first = _launch(wb, group, T)()
    old = wb.net.params
    (key, graph), = R.graphs(wb.net.graph).items()
    wb.net.params = common.params_to(common.init_params(
        R101.build_resnet101(num_classes=16, layers=REDUCED)[1], seed=4),
        "cuda")
    got = _launch(wb, group, T)()
    (key2, graph2), = R.graphs(wb.net.graph).items()
    assert key2 != key and graph2 is not graph
    assert not np.array_equal(got, first)
    monkeypatch.setattr(R, "engages", lambda device: False)
    want = _launch(wb, group, T)()
    np.testing.assert_array_equal(got, want)
    assert old  # the old parameters lived through the swap
