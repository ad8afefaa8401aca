"""CPU test of ``metrics/eval.graphed_step_share.py``: the share of the
eval's blend+encode steps replayed from a captured graph, read from fixed
counters of the program, and nothing from a program that counts no
replays:

    python3 -m pytest xfr_bench/test_graphed_step_share.py -q
"""

from __future__ import annotations

import os

import pytest

from xfr_bench import harness as H
from xfr_torch.utils import profiling

NAME = "eval.graphed_step_share"


@pytest.mark.parametrize("replays,share", [(16 * 12, 100.0), (12, 6.25),
                                           (0, 0.0)])
def test_reads_replays_over_steps(replays, share, monkeypatch):
    read = H.metric_reader(NAME)
    monkeypatch.setattr(profiling, "_counters", {
        "xfr.eval.steps": 16 * 12, "xfr.eval.rows_encoded": 512 * 12,
        "xfr.eval.rows_needed": 404 * 12,
        "xfr.eval.graph_replays": replays})
    assert read({"family": "eval", "units": 12}) == pytest.approx(share)
    assert read({"family": "bb", "units": 12}) is None


def test_reads_nothing_without_the_counters(monkeypatch):
    read = H.metric_reader(NAME)
    # a program without the captured encode: steps, no replays
    monkeypatch.setattr(profiling, "_counters", {"xfr.eval.steps": 192})
    assert read({"family": "eval", "units": 12}) is None
    monkeypatch.setattr(profiling, "_counters", {})
    assert read({"family": "eval", "units": 12}) is None
    monkeypatch.delattr(profiling, "counters")
    assert read({"family": "eval", "units": 12}) is None


def test_is_listed_with_the_eval_cells():
    bench = H.benchmark(os.path.dirname(H.HERE))
    entry, = [m for m in bench["per_layer"] if m["name"] == NAME]
    assert entry["source"] == "program_counter"
    assert entry["moves"] == "evals_per_s"
    assert entry["workloads"] == ["lcnn29.eval", "r101.eval"]
