"""bench_torch.py, the port of bench.py, on the CPU with the toy net.

Each function runs through its real code on tests/torch_fixtures'
twin of tests/fixtures.make_toy_wbnet at one or two iterations and few
masks; each of its exact checks raises when one output is perturbed;
its draws from the caller's RandomState equal bench.py's: the state after
each port function equals the state after bench.py's function on the JAX
toy net at the same counts (the whitebox and STRise cases of that
check compile JAX programs, and are opt-in with --runslow)."""

import json
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
import bench_torch as BT
from tests.fixtures import make_toy_wbnet
from tests.torch_fixtures import torch_twin

# the toy net's counts: 2 timed mixes, 2 timed STRise maps of 32 masks,
# 3 eval groups (so that group 2 is held to group 0)
COUNTS = {"whitebox": dict(n_iters=2),
          "blackbox": dict(n_maps=2, num_masks=32),
          "eval": dict(n_groups=3)}
CARD = {"name": "NVIDIA H100 80GB HBM3", "power_limit": "700.00 W"}


@pytest.fixture(scope="module")
def nets():
    jwb = make_toy_wbnet(num_classes=4, seed=0, subtree_mode="norelu")
    jwb.wsebp_dtype = jnp.bfloat16
    twb = torch_twin(jwb)
    twb.wsebp_dtype = torch.bfloat16
    return jwb, twb


def _port_fn(name):
    return {"whitebox": BT.bench_whitebox, "blackbox": BT.bench_blackbox,
            "eval": BT.bench_eval}[name]


def _run_port(twb, name, rng=None):
    rng = np.random.RandomState(0) if rng is None else rng
    times = _port_fn(name)(twb, rng, **COUNTS[name])
    twb.net.reset_classifier()
    return times, rng


def test_card_and_emit_keep_bench_contract(capsys, monkeypatch):
    """The card's fields parsed from nvidia-smi's line (the first card's,
    of two), and _emit's line: bench.py's keys and values, the card's
    fields, no bound."""
    from xfr_torch.utils import device as D

    def smi(cmd, **kw):
        assert cmd == ["nvidia-smi", "--query-gpu=name,power.limit",
                       "--format=csv,noheader"]
        return subprocess.CompletedProcess(
            cmd, 0, stdout="NVIDIA H100 80GB HBM3, 700.00 W\n"
                           "NVIDIA H100 PCIe, 350.00 W\n")

    monkeypatch.setattr(D.subprocess, "run", smi)
    assert D.card_name_and_power_limit() == CARD
    times = [0.5, 0.25, 0.4]
    bench._emit("m", times, "maps/sec/chip", 0.04, per=32)
    want = json.loads(capsys.readouterr().out)
    rec = BT._emit("m", times, "maps/sec/chip", 0.04, CARD, per=32)
    got = json.loads(capsys.readouterr().out)
    assert got == rec
    assert "bound" not in got
    assert set(got) == set(want) | {"name", "power_limit"}
    assert {k: got[k] for k in want} == want
    assert got["value"] == round(32 / 0.4, 4)
    assert [got[k] for k in CARD] == list(CARD.values())


@pytest.mark.parametrize("name", sorted(COUNTS))
def test_function_runs(nets, name):
    """The port function through its checks: one rate a timed iteration."""
    times, _ = _run_port(nets[1], name)
    n = next(iter(COUNTS[name].values()))
    assert len(times) == n and all(t > 0 for t in times)


# bench.py's whitebox and STRise functions compile the toy programs on
# the JAX side, 4-6 s each here: opt-in
@pytest.mark.parametrize("name", [
    "eval", pytest.param("whitebox", marks=pytest.mark.slow),
    pytest.param("blackbox", marks=pytest.mark.slow)])
def test_draws_as_bench_does(nets, name):
    """The RandomState after the port function equals the state after
    bench.py's function on the JAX toy net at the same counts."""
    jwb, twb = nets
    _, rng = _run_port(twb, name)
    jrng = np.random.RandomState(0)
    getattr(bench, "bench_" + name)(jwb, jrng, **COUNTS[name])
    jwb.net.reset_classifier()
    got, want = rng.get_state(), jrng.get_state()
    assert got[0] == want[0] and got[2:] == want[2:]
    np.testing.assert_array_equal(got[1], want[1])


def test_run_prints_bench_lines_in_order(nets, capsys):
    _, twb = nets
    recs = BT.run(twb, CARD, wb_iters=1, bb_maps=1, bb_high_maps=1,
                  eval_groups=1, num_masks=16)
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()
             if x.startswith("{")]
    assert lines == recs
    assert [r["metric"] for r in recs] == [
        BT.WB_METRIC, BT.BB_METRIC, BT.BB_HIGH_METRIC, BT.EVAL_METRIC,
        BT.WB_METRIC]
    assert recs[0] == recs[-1]
    assert all(r["name"] == CARD["name"] and "bound" not in r
               for r in recs)


def _perturb(a):
    a = np.array(a, copy=True)
    a.flat[0] = np.nextafter(a.flat[0], np.inf)
    return a


def test_check_same_is_bitwise():
    a = [np.zeros(3, np.float32), (np.ones(2), np.array([True, False]))]
    BT.check_same("same", a, [x for x in a])
    with pytest.raises(AssertionError, match="differs"):
        BT.check_same("differs", a, [_perturb(a[0]), a[1]])
    with pytest.raises(AssertionError):
        BT.check_same("dtype", [np.zeros(3, np.float64)], [a[0]])
    with pytest.raises(AssertionError):
        BT.check_same("0.0 against -0.0", [np.zeros(1)], [-np.zeros(1)])


def test_whitebox_check_raises_on_perturbed_mix(nets, monkeypatch):
    """The weighted-subtree map of the first timed mix's first probe is
    moved by one float step: its mix no longer equals the warm-up's."""
    _, twb = nets
    launch = twb.launch_weighted_subtree_ebp_batch
    calls = []

    def perturbed(*a, **kw):
        finish = launch(*a, **kw)
        calls.append(1)
        if len(calls) != 2:
            return finish

        def fin():
            out = finish()
            return [(_perturb(out[0][0]),) + tuple(out[0][1:])] + out[1:]
        return fin

    monkeypatch.setattr(twb, "launch_weighted_subtree_ebp_batch", perturbed)
    with pytest.raises(AssertionError, match="whitebox mix 0 against the "
                                             "warm-up"):
        _run_port(twb, "whitebox")
    twb.net.reset_classifier()


def test_blackbox_check_raises_on_perturbed_rerun(nets, monkeypatch):
    """The rerun of seed 0 after the timed maps gives a map one float step
    off the warm-up's."""
    from xfr_torch.blackbox.strise import STRise

    _, twb = nets
    launch = STRise.launch_evaluate
    calls = []

    def perturbed(self, *a, **kw):
        finish = launch(self, *a, **kw)
        calls.append(1)
        # warm-up, maps 1..n_maps, then the rerun
        if len(calls) != COUNTS["blackbox"]["n_maps"] + 2:
            return finish
        return lambda: _perturb(finish())

    monkeypatch.setattr(STRise, "launch_evaluate", perturbed)
    with pytest.raises(AssertionError, match="STRise seed 0 after the timed "
                                             "maps"):
        _run_port(twb, "blackbox")


@pytest.mark.parametrize("group,match", [(0, "group 0 against the warm-up"),
                                         (2, "group 2 against group 0")])
def test_eval_check_raises_on_perturbed_group(nets, monkeypatch, group,
                                              match):
    """One distance of one timed group's first map moved by one float
    step (the warm-up group launches first, 4 maps a group)."""
    from xfr_torch.inpainting_game import protocol as ipg

    _, twb = nets
    launch = ipg.TwinClsBatch.launch
    calls = []

    def perturbed(self, smap):
        finish = launch(self, smap)
        calls.append(1)
        if len(calls) != 4 * (group + 1) + 1:
            return finish

        def fin():
            cls, pg, pr = finish()
            return cls, _perturb(pg), pr
        return fin

    monkeypatch.setattr(ipg.TwinClsBatch, "launch", perturbed)
    with pytest.raises(AssertionError, match=match):
        _run_port(twb, "eval")
