"""CPU test of ``metrics/eval.own_end_read_share.py``: the share of the
eval's blend+encode reads made after their own launch's end, read from
fixed counters of the program, and nothing from a program that counts no
reads:

    python3 -m pytest xfr_bench/test_own_end_read_share.py -q
"""

from __future__ import annotations

import os

import pytest

from xfr_bench import harness as H
from xfr_torch.utils import profiling

NAME = "eval.own_end_read_share"


@pytest.mark.parametrize("own_end,share", [(12, 100.0), (3, 25.0),
                                           (None, 0.0)])
def test_reads_own_end_reads_over_reads(own_end, share, monkeypatch):
    read = H.metric_reader(NAME)
    counters = {"xfr.eval.steps": 16 * 12, "xfr.eval.reads": 12}
    if own_end is not None:
        counters["xfr.eval.reads_after_own_end"] = own_end
    monkeypatch.setattr(profiling, "_counters", counters)
    assert read({"family": "eval", "units": 12}) == pytest.approx(share)
    assert read({"family": "bb", "units": 12}) is None


def test_reads_nothing_without_the_counters(monkeypatch):
    read = H.metric_reader(NAME)
    # a program without the read counters: steps, no reads
    monkeypatch.setattr(profiling, "_counters", {"xfr.eval.steps": 192})
    assert read({"family": "eval", "units": 12}) is None
    monkeypatch.setattr(profiling, "_counters", {})
    assert read({"family": "eval", "units": 12}) is None
    monkeypatch.delattr(profiling, "counters")
    assert read({"family": "eval", "units": 12}) is None


def test_is_listed_with_the_eval_cells():
    bench = H.benchmark(os.path.dirname(H.HERE))
    entry, = [m for m in bench["per_layer"] if m["name"] == NAME]
    assert entry == {"name": NAME, "unit": "%", "better": "higher",
                     "source": "program_counter", "layer": "Eval protocol",
                     "moves": "evals_per_s",
                     "workloads": ["lcnn29.eval", "r101.eval"]}
