"""CPU tests of the benchmark's reading of the program's spans and
counters (``xfr_bench/program_trace.py`` and the readers that use it):

    python3 -m pytest xfr_bench -q

The attribution of idle gaps to ``<range>/<span>`` sums, range by range,
to what ``harness.trace_summary`` reads without the spans; each reader
reads its span or counter in its own family only, and reads nothing
from a program without them; a small traced window of each cell kind
puts the program's spans in the trace.
"""

from __future__ import annotations

import json
import os

import pytest
import torch

from xfr_bench import harness as H
from xfr_bench import program_trace as PT
from xfr_torch.utils import profiling

BENCH = H.benchmark(os.path.dirname(H.HERE))
SMALL_CFG = {"layers": [1, 1, 1, 1], "num_classes": 101}

# (reader, family, the program's span it reads)
SPAN_READERS = [
    ("eval.enqueue_s_per_group", "eval", "xfr.eval.encode"),
    ("eval.plane_s_per_group", "eval", "xfr.eval.plane"),
    ("eval.iou_s_per_group", "eval", "xfr.eval.iou"),
    ("bb.prior_s_per_map", "bb", "xfr.bb.prior"),
    ("bb.draw_s_per_map", "bb", "xfr.bb.masks"),
    ("bb.score_enqueue_s_per_map", "bb", "xfr.bb.score"),
]


class _FakeProf:
    def __init__(self, events):
        self.events = events

    def export_chrome_trace(self, path):
        with open(path, "w") as f:
            json.dump({"traceEvents": self.events}, f)


def _ann(name, ts, dur):
    return {"cat": "user_annotation", "name": name, "ts": ts, "dur": dur}


# a window of 100 us: launch [0, 30) holding the score span [5, 25) and
# in it a chunk span [10, 15); drain [60, 100) holding finish [60, 90);
# kernels [12, 40) and copies [70, 80)
EVENTS = [
    _ann(H.WINDOW, 0, 100),
    _ann("bb.launch", 0, 30),
    _ann("xfr.bb.score", 5, 20),
    _ann("xfr.bb.chunk", 10, 5),
    _ann("bb.drain", 60, 40),
    _ann("xfr.bb.finish", 60, 30),
    {"cat": "gpu_user_annotation", "name": "xfr.bb.score", "ts": 12,
     "dur": 28},
    {"cat": "kernel", "name": "k1", "ts": 12, "dur": 18},
    {"cat": "kernel", "name": "k2", "ts": 25, "dur": 15},
    {"cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 70, "dur": 10},
]


def test_idle_gaps_go_to_the_innermost_span_and_sum_by_range(tmp_path):
    got = PT.attribute(EVENTS, ("bb.launch", "bb.drain"))
    gaps = got["idle_gaps"]
    assert gaps == pytest.approx({
        "bb.launch": 5e-6,                  # [0, 5)
        "bb.launch/xfr.bb.score": 5e-6,     # [5, 10)
        "bb.launch/xfr.bb.chunk": 2e-6,     # [10, 12)
        "bb.drain/xfr.bb.finish": 20e-6,    # [60, 70), [80, 90)
        "bb.drain": 10e-6,                  # [90, 100)
        "outside_the_harness_ranges": 20e-6,  # [40, 60)
    })
    want = dict(H.trace_summary(_FakeProf(EVENTS), ("bb.launch", "bb.drain"),
                                str(tmp_path / "t.json"))["idle_gaps"])
    sums = {}
    for name, s in gaps.items():
        key = name.split("/")[0]
        sums[key] = sums.get(key, 0.0) + s
    assert sums == pytest.approx(want)
    assert got["busy_s"] == pytest.approx(38e-6)  # [12, 40), [70, 80)
    assert got["spans"] == {
        "xfr.bb.chunk": {"calls": 1, "s": pytest.approx(5e-6),
                         "self_s": pytest.approx(5e-6)},
        "xfr.bb.finish": {"calls": 1, "s": pytest.approx(30e-6),
                          "self_s": pytest.approx(30e-6)},
        "xfr.bb.score": {"calls": 1, "s": pytest.approx(20e-6),
                         "self_s": pytest.approx(15e-6)},
    }


def test_spans_are_clipped_to_the_window():
    ev = [_ann(H.WINDOW, 10, 50), _ann("r", 0, 40),
          _ann("xfr.a", 0, 20), _ann("xfr.a", 30, 40),
          {"cat": "kernel", "name": "k", "ts": 35, "dur": 10}]
    got = PT.attribute(ev, ("r",))
    assert got["spans"]["xfr.a"]["calls"] == 2
    assert got["spans"]["xfr.a"]["s"] == pytest.approx(40e-6)  # [10,20) [30,60)
    assert got["idle_gaps"] == pytest.approx({
        "r/xfr.a": 15e-6,     # [10, 20), [30, 35)
        "r": 10e-6,           # [20, 30)
        "outside_the_harness_ranges": 15e-6})  # [45, 60)


@pytest.mark.parametrize("name,family,span", SPAN_READERS)
def test_span_readers(name, family, span, monkeypatch):
    monkeypatch.setattr(profiling, "_span_seconds", {span: 6.0})
    read = H.metric_reader(name)
    other = "bb" if family == "eval" else "eval"
    assert read({"family": family, "units": 3}) == pytest.approx(2.0)
    assert read({"family": other, "units": 3}) is None
    monkeypatch.setattr(profiling, "_span_seconds", {})
    assert read({"family": family, "units": 3}) is None
    monkeypatch.delattr(profiling, "span_seconds")
    assert read({"family": family, "units": 3}) is None


def test_padded_row_share_reader(monkeypatch):
    read = H.metric_reader("eval.padded_row_share")
    monkeypatch.setattr(profiling, "_counters", {
        "xfr.eval.rows_needed": 404 * 12, "xfr.eval.rows_encoded": 512 * 12,
        "xfr.eval.steps": 16 * 12})
    assert read({"family": "eval", "units": 12}) == pytest.approx(
        100 * 108 / 512)
    assert read({"family": "bb", "units": 12}) is None
    monkeypatch.setattr(profiling, "_counters", {})
    assert read({"family": "eval", "units": 12}) is None
    monkeypatch.delattr(profiling, "counters")
    assert read({"family": "eval", "units": 12}) is None


def test_new_readers_are_listed_with_their_cells():
    entries = {m["name"]: m for m in BENCH["per_layer"]}
    for name, family, _ in SPAN_READERS:
        assert entries[name]["source"] == "program_span"
        assert all(w.endswith(".eval" if family == "eval" else ".strise")
                   for w in entries[name]["workloads"])
    assert entries["eval.padded_row_share"]["source"] == "program_counter"


@pytest.mark.parametrize("name,spans", [
    ("r101.strise", {"xfr.bb.launch", "xfr.bb.prior", "xfr.bb.masks",
                     "xfr.bb.score", "xfr.bb.finish"}),
    ("lcnn29.eval", {"xfr.eval.plane", "xfr.eval.encode", "xfr.eval.blend",
                     "xfr.eval.finish", "xfr.eval.iou"}),
])
def test_small_traced_window_holds_the_program_spans(name, spans):
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        wl = H.workload(BENCH, name)
        small = ({"num_masks": 128, "probe_pool": 3, "trace_units": 1}
                 if name.endswith("strise") else
                 {"maps": 2, "percentiles": [0, 20], "pool_values": 100000,
                  "trace_units": 1})
        out = PT.trace_cell(wl, 2 ** 40 + 17, 0.0, "cpu", SMALL_CFG, small)
    finally:
        torch.set_num_threads(saved)
    assert out["units"] == 1
    assert set(out["spans"]) == spans
    assert out["busy_s"] == 0.0  # the CPU: every second of it idle
    assert sum(s for _, s in out["idle_gaps"]) == pytest.approx(
        out["window_s"], rel=1e-3)
    if name.endswith("eval"):
        # 2 maps of T = 21 rows, one step of 32 rows each, read back in
        # one finish (on the CPU, not after its own launch's end)
        assert out["counters"] == {"xfr.eval.steps": 2,
                                   "xfr.eval.rows_encoded": 64,
                                   "xfr.eval.rows_needed": 42,
                                   "xfr.eval.reads": 1}
        assert out["spans"]["xfr.eval.blend"]["calls"] == 2
        assert any(n == "eval.launch/xfr.eval.encode" or
                   n == "eval.launch/xfr.eval.blend"
                   for n, _ in out["idle_gaps"])
