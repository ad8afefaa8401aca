"""STRise on a card: each chunk's encode replays one CUDA graph of the
matcher's forward, captured at the scoring precision, and the mean-EBP
prior's walk one graph of its own, each with the bits of the eager
forward or walk; and the drain reads its map's results after
that map's launch alone, so work enqueued behind the launch (the next
map of a pipeline) does not hold it back.  The matcher is SENet-50-256
at one block a stage (full widths) on seeded random weights, the prior's
net a ResNet-101 at one block a stage.  On the CPU nothing is captured;
there the staged form (each chunk and the prior's input copied into a
graph's static input, the graph replayed) runs with an eager stand-in for
the capture (``torch_fixtures.eager_replay``) and gives the eager path's
bits, and a replay counts the gates its capture counted.

The card tests carry the ``cuda`` marker and skip without a card.  This
file imports neither JAX nor the JAX package:

    python -m pytest tests/test_torch_strise_card.py --noconftest -q
"""

import gc
import time
import weakref

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from torch_fixtures import eager_replay  # noqa: F401
from xfr_bench import harness as H
from xfr_torch import replay as R
from xfr_torch.blackbox import strise as S
from xfr_torch.blackbox.strise import STRise
from xfr_torch.utils import profiling
from xfr_torch.utils.device import precision_scope


def _nets(device):
    cfg = H.config("senet50_256")
    cfg["layers"] = [1, 1, 1, 1]
    params = H.make_weights(cfg["reference"].param_shapes(cfg), 5, device)
    pcfg = H.config("resnet101_l2")
    pcfg.update(layers=[1, 1, 1, 1], num_classes=101,
                program_name="resnetv4_pytorch")
    pparams = H.make_weights(pcfg["reference"].param_shapes(pcfg), 6,
                             device)
    return {("senet50_256", 6): cfg["program"].program(cfg, params, device),
            ("resnetv4_pytorch", None): pcfg["program"].program(
                pcfg, pparams, device)}


def _launch(nets, device, num_masks=256, black_box="senet50_256", chunk=64,
            **kw):
    rng = np.random.RandomState(3)
    probe = rng.randint(0, 256, (224, 224, 3)).astype(np.uint8)
    ref = np.clip(probe.astype(int) + rng.randint(-16, 17, probe.shape), 0,
                  255).astype(np.uint8)
    gal = [rng.randint(0, 256, (224, 224, 3)).astype(np.uint8)
           for _ in range(2)]
    st = STRise(probe=probe, refs=[ref], gallery=gal,
                black_box=black_box, net_dict=nets, num_masks=num_masks,
                num_mask_elements=2, seed=9, batch_size=chunk,
                score_precision="high", device=device, **kw)
    return st, st.launch_evaluate()


@pytest.mark.cuda
def test_drain_reads_after_its_own_launch_alone():
    _card()
    nets = _nets("cuda")
    st, finish = _launch(nets, "cuda")
    alone = finish(), st.mask_scores.copy()
    torch.cuda.synchronize()

    st, finish = _launch(nets, "cuda")
    # a later launch's work, queued behind this one: about a second
    torch.cuda._sleep(int(2e9))
    t0 = time.perf_counter()
    smap = finish()
    waited = time.perf_counter() - t0
    queued_still_runs = not torch.cuda.current_stream().query()
    torch.cuda.synchronize()
    assert queued_still_runs, waited
    np.testing.assert_array_equal(smap, alone[0])
    np.testing.assert_array_equal(st.mask_scores, alone[1])


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs and streams")


@pytest.mark.cuda
def test_graphed_chunks_equal_the_eager_chunks(monkeypatch):
    _card()
    nets = _nets("cuda")
    st, finish = _launch(nets, "cuda")
    graphed = finish(), st.mask_scores.copy()
    (key,) = R.graphs(nets[("senet50_256", 6)].net.graph)
    assert key.tag == "encode"
    monkeypatch.setattr(R, "engages", lambda device: False)
    st, finish = _launch(nets, "cuda")
    np.testing.assert_array_equal(finish(), graphed[0])
    np.testing.assert_array_equal(st.mask_scores, graphed[1])


@pytest.mark.cuda
def test_graphed_prior_equals_the_eager_prior(monkeypatch):
    """The mean-EBP prior's walk, one replay of its captured graph, against
    the eager walk: the same bits."""
    _card()
    nets = _nets("cuda")
    st, finish = _launch(nets, "cuda")
    finish()
    graphed = st.prior.cpu().numpy()
    walks = [k for k in R.graphs(nets[("resnetv4_pytorch", None)].net.graph)
             if k.tag[0] == "pooled_ebp"]
    assert len(walks) == 1
    monkeypatch.setattr(R, "engages", lambda device: False)
    st, finish = _launch(nets, "cuda")
    finish()
    np.testing.assert_array_equal(st.prior.cpu().numpy(), graphed)


def test_cpu_captures_nothing():
    nets = _nets("cpu")
    st, finish = _launch(nets, "cpu", num_masks=64)
    assert np.isfinite(finish()).all()
    assert R.graphs(nets[("senet50_256", 6)].net.graph) == {}
    assert R.graphs(nets[("resnetv4_pytorch", None)].net.graph) == {}


def test_strise_reads_through_the_shared_helpers():
    """STRise's drain and the eval's finish read after a launch's end
    through one pair of helpers in ``utils.device``; STRise's module still
    gives both under their names (the benchmark's SENet cell imports them
    from there).  On the CPU no end is recorded and the block runs as it
    is."""
    from xfr_torch.blackbox.strise import _launch_end, _reading_after
    from xfr_torch.ebp import engine as E
    from xfr_torch.utils import device as D

    assert _launch_end is D._launch_end is E._launch_end
    assert _reading_after is D._reading_after is E._reading_after
    cpu = torch.device("cpu")
    assert _launch_end(cpu) is None
    with _reading_after(None, cpu):
        x = torch.arange(3.0).cpu()
    assert x.tolist() == [0.0, 1.0, 2.0]


def test_a_finished_map_is_freed_with_its_last_reference():
    """A drained STRise holds no reference cycle: with Python's cycle
    collector off, dropping the (STRise, finish) pair frees it and its
    masks at once, so a run of maps holds only the maps in flight."""
    nets = _nets("cpu")
    gc.collect()
    gc.disable()
    try:
        st, finish = _launch(nets, "cpu", num_masks=64)
        finish()
        gone = [weakref.ref(st)] + [weakref.ref(v) for v in vars(st).values()
                                    if isinstance(v, torch.Tensor)]
        assert len(gone) > 1
        del st, finish
        assert [r() for r in gone] == [None] * len(gone)
    finally:
        gc.enable()


@pytest.mark.parametrize("black_box,k1", [("senet50_256", False),
                                          ("senet50_256", True),
                                          ("resnetv4_pytorch", False)])
def test_staged_chunks_and_prior_equal_the_eager_path(request, black_box,
                                                      k1):
    """The staged chunks (the materialized blend's NHWC-strided batch, or
    K1's NCHW output, copied into the graph's input of the same strides)
    and the staged prior give the eager path's bits, map after map; the
    chunk encode and the prior's walk keep one graph each in the nets'
    one cache, also where one ResNet-101 is both the matcher and the
    prior's net (``r101.strise``'s aliasing)."""
    nets = _nets("cpu")
    for wb in nets.values():
        wb.batch_size = 4  # the probe's, refs' and gallery's encodes
    proxy = nets[("resnetv4_pytorch", None)]
    if black_box == "resnetv4_pytorch":
        nets = {("resnetv4_pytorch", 6): proxy,
                ("resnetv4_pytorch", None): proxy}
    st, finish = _launch(nets, "cpu", num_masks=32, black_box=black_box,
                         chunk=16, use_pallas_blend=k1)
    eager = finish(), st.mask_scores.copy(), st.prior.numpy().copy()

    request.getfixturevalue("eager_replay")
    for _ in range(2):
        st, finish = _launch(nets, "cpu", num_masks=32,
                             black_box=black_box, chunk=16,
                             use_pallas_blend=k1)
        np.testing.assert_array_equal(finish(), eager[0])
        np.testing.assert_array_equal(st.mask_scores, eager[1])
        np.testing.assert_array_equal(st.prior.numpy(), eager[2])
    tags = sorted(k.tag if k.tag == "encode" else k.tag[0]
                  for wb in {id(w): w for w in nets.values()}.values()
                  for k in R.graphs(wb.net.graph))
    assert tags == ["encode", "pooled_ebp"]
    (key,) = [k for k in R.graphs(nets[(black_box, 6)].net.graph)
              if k.tag == "encode"]
    with precision_scope("high"):
        high = R.precision()
    assert key.shape == (16, 3, 224, 224) and key.precision == high
    nchw = torch.empty(key.shape).stride()
    assert (key.stride == nchw) == k1


def test_a_replay_counts_its_gates(eager_replay):
    """A replay of the chunk encode counts the squeeze-excite gate
    multiplies of its batch while a profiler records, as its capture's
    forward counted them: 4 gates a row at one block a stage, none on a
    ResNet; nothing without a profiler."""
    nets = _nets("cpu")
    x = torch.zeros((2, 3, 224, 224))
    for name, gates in ((("senet50_256", 6), 4 * 2),
                        (("resnetv4_pytorch", None), 0)):
        net = nets[name].net
        e = torch.ones((1, net.embed_dim))

        def score():
            S._encode_and_score(net.graph, net.encode_tensor, net.params, x,
                                e, e)

        score()  # captures
        assert len(R.graphs(net.graph)) == 1
        before = profiling.counters()
        with profile(activities=[ProfilerActivity.CPU]):
            score()
        assert profiling.counters().get("xfr.enc.se_gates", 0) == \
            before.get("xfr.enc.se_gates", 0) + gates
        before = profiling.counters()
        score()
        assert profiling.counters() == before
