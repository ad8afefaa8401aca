"""CPU test of ``metrics/bb.fused_bn_share.py`` and
``metrics/eval.fused_bn_share.py``: the share of BatchNorm rows applied
inside the fused epilogue, read from fixed counters of the program, and
nothing from a program that counts no BatchNorm rows:

    python3 -m pytest xfr_bench/test_fused_bn_share.py -q
"""

from __future__ import annotations

import os

import pytest

from xfr_bench import harness as H
from xfr_torch.utils import profiling

CELLS = {"bb.fused_bn_share": ("bb", ["r101.strise", "senet50.strise"],
                               "bb_maps_per_s"),
         "eval.fused_bn_share": ("eval", ["r101.eval"], "evals_per_s")}


@pytest.mark.parametrize("name", sorted(CELLS))
@pytest.mark.parametrize("fused,share", [(6528 * 100, 100 * 6528 / 6529),
                                         (3264 * 100, 50 * 6528 / 6529),
                                         (None, 0.0)])
def test_reads_fused_rows_over_all_rows(name, fused, share, monkeypatch):
    """A map's 6,528 scored rows fused, the prior walk's one row not."""
    family = CELLS[name][0]
    read = H.metric_reader(name)
    counters = {"xfr.enc.bn_rows": 6529 * 100}
    if fused is not None:
        counters["xfr.enc.bn_rows_fused"] = fused
    monkeypatch.setattr(profiling, "_counters", counters)
    assert read({"family": family, "units": 2}) == pytest.approx(share)
    other = "eval" if family == "bb" else "bb"
    assert read({"family": other, "units": 2}) is None


@pytest.mark.parametrize("name", sorted(CELLS))
def test_reads_nothing_without_the_counters(name, monkeypatch):
    family = CELLS[name][0]
    read = H.metric_reader(name)
    # a matcher without BatchNorm, or a program that counts none
    monkeypatch.setattr(profiling, "_counters", {"xfr.eval.steps": 192})
    assert read({"family": family, "units": 12}) is None
    monkeypatch.delattr(profiling, "counters")
    assert read({"family": family, "units": 12}) is None


@pytest.mark.parametrize("name", sorted(CELLS))
def test_is_listed_with_its_cells(name):
    bench = H.benchmark(os.path.dirname(H.HERE))
    entry, = [m for m in bench["per_layer"] if m["name"] == name]
    _, cells, moves = CELLS[name]
    assert entry["source"] == "program_counter"
    assert entry["layer"] == "Matchers and ops against the peak"
    assert entry["moves"] == moves
    assert entry["workloads"] == cells
