"""CPU tests of the benchmark harness, at small sizes:

    python3 -m pytest xfr_bench -q

Every file that BENCHMARK.json names loads by name, and a new traffic
mix, configuration or metric is found as a new file; the FLOP counter
gives the counts of the shapes; the plain reference agrees with the
program at reduced depth; a small run of each cell kind comes out
correct, and comes out not correct with the timed path broken
underneath.  The control's test needs the card (marker ``cuda``).
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time

import pytest
import torch
import torch.nn.functional as F

from xfr_bench import harness as H
from xfr_bench import run as RUN

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = H.benchmark(ROOT)
SMALL_CFG = {"layers": [1, 1, 1, 1], "num_classes": 101}
SMALL_TRAFFIC = {
    "strise": {"num_masks": 128, "probe_pool": 3, "check_units": 2},
    "evaluation": {"maps": 2, "percentiles": [0, 20], "check_units": 2,
                   "pool_values": 100000},
}


@pytest.fixture(autouse=True)
def _threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def test_every_named_file_loads():
    for c in BENCH["configs"]:
        cfg = H.config(c["name"])
        assert cfg["name"] == c["name"]
        assert os.path.exists(os.path.join(ROOT, c["file"]))
        assert callable(cfg["program"].program)
        assert callable(cfg["reference"].encode)
    for w in BENCH["workloads"]:
        K = H.kind(H.traffic(w["traffic"])["kind"])
        assert K.RATE in {m["name"] for m in BENCH["end_to_end"]}
        assert H.limits(w["name"]), w["name"]
    for m in BENCH["per_layer"]:
        assert callable(H.metric_reader(m["name"]))


def test_new_files_are_found_without_edits(tmp_path, monkeypatch):
    for sub in ("configs", "traffic", "metrics", "limits"):
        shutil.copytree(os.path.join(H.HERE, sub), tmp_path / sub)
    tr = H.traffic("strise_cli")
    tr["num_masks"] = 640
    (tmp_path / "traffic" / "strise_small.json").write_text(json.dumps(tr))
    (tmp_path / "metrics" / "bb.new_count.py").write_text(
        "def read(run):\n    return 7.0 if run['family'] == 'bb' "
        "else None\n")
    cfg = H.read_json("configs", "resnet101_l2.json")
    cfg["name"] = "resnet50_like"
    cfg["layers"] = [3, 4, 6, 3]
    (tmp_path / "configs" / "resnet50_like.json").write_text(json.dumps(cfg))
    shutil.copy(tmp_path / "configs" / "resnet101_l2.py",
                tmp_path / "configs" / "resnet50_like.py")
    (tmp_path / "limits" / "new.cell.json").write_text(json.dumps(
        {"numbers": {"map_gap": {"limit": 0.5}}}))
    monkeypatch.setattr(H, "HERE", str(tmp_path))
    assert H.traffic("strise_small")["num_masks"] == 640
    assert H.metric_reader("bb.new_count")({"family": "bb"}) == 7.0
    assert H.metric_reader("bb.new_count")({"family": "eval"}) is None
    new = H.config("resnet50_like")
    assert new["layers"] == [3, 4, 6, 3]
    assert callable(new["program"].program)
    assert H.limits("new.cell") == {"map_gap": 0.5}


def _meta_macs(encode, cfg, chw):
    """Multiply-adds of one forward, counted from the shapes that
    F.conv2d and F.linear see on the meta device."""
    count = [0]
    conv, linear = F.conv2d, F.linear

    def counting_conv(x, w, b=None, stride=1, padding=0, *a):
        y = conv(x, w, b, stride, padding, *a)
        count[0] += y.numel() * w[0].numel()
        return y

    def counting_linear(x, w, b=None):
        y = linear(x, w, b)
        count[0] += y.numel() * w.shape[1]
        return y

    shapes = cfg["reference"].param_shapes(cfg)
    params = {n: {k: torch.empty(s, device="meta") for k, s in p.items()}
              for n, p in shapes.items()}
    F.conv2d, F.linear = counting_conv, counting_linear
    try:
        encode(params, cfg, torch.empty((1,) + chw, device="meta"))
    finally:
        F.conv2d, F.linear = conv, linear
    return count[0]


@pytest.mark.parametrize("name", ["resnet101_l2", "lightcnn29_v2"])
def test_flop_counter_matches_the_shapes(name):
    cfg = H.config(name)
    R, chw = cfg["reference"], tuple(cfg["input_chw"])
    macs = R.forward_macs(cfg, chw)
    assert macs == _meta_macs(R.encode, cfg, chw)
    if name == "resnet101_l2":
        # the stem: 64 x 112 x 112 outputs of 3 x 7 x 7 products
        assert R.first_conv_macs(cfg, chw) == 64 * 112 * 112 * 3 * 49
        # fc2 over 65,359 classes adds 512 products a class
        assert R.forward_macs(cfg, chw, head=True) - macs == 65359 * 512
        assert 7.0e9 < macs < 8.0e9  # about 15 GFLOP a 224x224 image
    else:
        # conv1: 96 x 128 x 128 outputs of 1 x 5 x 5 products; fc 8192->256
        assert 3.0e9 < macs < 4.0e9
        assert macs > 96 * 128 * 128 * 25 + 8192 * 256


def _small(name, device="cpu"):
    cfg = H.config(name)
    cfg.update(SMALL_CFG)
    params = H.make_weights(cfg["reference"].param_shapes(cfg), 20240511,
                            device)
    return cfg, params


@pytest.mark.parametrize("name", ["resnet101_l2", "lightcnn29_v2"])
def test_reference_encode_matches_the_program(name):
    cfg, params = _small(name)
    wb = cfg["program"].program(cfg, params, "cpu")
    g = torch.Generator().manual_seed(3)
    x = torch.rand((3,) + tuple(cfg["input_chw"]), generator=g) * 50
    with torch.no_grad():
        want = cfg["reference"].encode(params, cfg, x)
        got = wb.net.encode(x)
    err = (got - want).abs().max() / want.abs().max()
    assert err < 1e-5, err


def test_reference_mean_ebp_matches_the_program():
    cfg, params = _small("resnet101_l2")
    wb = cfg["program"].program(cfg, params, "cpu")
    R = cfg["reference"]
    g = torch.Generator().manual_seed(4)
    img = torch.randint(0, 256, (224, 224, 3), generator=g).float()
    x = R.preprocess(img[None])
    n = cfg["num_classes"]
    _, got = wb._ebp_pooled_fn()(wb.net.params, x, torch.full((1, n), 1 / n))
    want = R.mean_ebp_conv1(params, cfg, x)
    err = (got - want).abs().max() / want.abs().max()
    assert err < 1e-5, err


def _run(name, seconds=1.0):
    wl = H.workload(BENCH, name)
    tr = H.traffic(wl["traffic"])
    res, _ = RUN.run(BENCH, wl, 2 ** 40 + 17, seconds, False, "cpu",
                     time.perf_counter(), SMALL_CFG,
                     SMALL_TRAFFIC[tr["kind"]])
    return res


def _faults(kind, monkeypatch):
    """The faults of a cell kind, each a function that plants it."""
    if kind == "strise":
        from xfr_torch.blackbox import strise as S

        def altered():
            combine = S.STRise._select_combine_fn

            def planted(n):
                fn = combine(n)

                def wrong(*a, **k):
                    cts, npos, smap = fn(*a, **k)
                    return cts, npos, smap.flip(0)
                return wrong
            monkeypatch.setattr(S.STRise, "_select_combine_fn",
                                staticmethod(planted))

        def half_left_out():
            score = S._encode_and_score

            def planted(graph, enc, params, x, ref_e, gal_e):
                h = x.shape[0] // 2
                r, g = score(graph, enc, params, x[:h], ref_e, gal_e)
                return torch.cat([r, r]), torch.cat([g, g])
            monkeypatch.setattr(S, "_encode_and_score", planted)
        return {"altered": altered, "half_left_out": half_left_out}

    from xfr_torch.ebp import engine as E
    from xfr_torch.inpainting_game import protocol as P

    def altered():
        launch = P.TwinClsBatch.launch

        def planted(self, smap):
            fin = launch(self, smap)

            def wrong():
                cls, pg, pr = fin()
                return cls, pg * 1.5, pr
            return wrong
        monkeypatch.setattr(P.TwinClsBatch, "launch", planted)

    def half_left_out():
        blend = E._threshold_blend

        def planted(counts, t0, T, orig, inp, rows):
            out = blend(counts, t0, T, orig, inp, rows)
            out[rows.shape[0] // 2:] = orig
            return out
        monkeypatch.setattr(E, "_threshold_blend", planted)
    return {"altered": altered, "half_left_out": half_left_out}


@pytest.mark.parametrize("name", ["r101.strise", "r101.eval",
                                  "lcnn29.eval"])
def test_small_run_is_correct(name):
    res = _run(name)
    assert res["correct"], res["compared"]
    assert list(res)[-1] == "compared"
    rate = H.kind(H.traffic(H.workload(BENCH, name)["traffic"])["kind"]).RATE
    assert res["metrics"][rate]["value"] > 0
    assert res["metrics"]["setup_s"]["value"] > 0


@pytest.mark.parametrize("fault", ["altered", "half_left_out"])
@pytest.mark.parametrize("name", ["r101.strise", "lcnn29.eval"])
def test_broken_path_is_not_correct(name, fault, monkeypatch):
    kind = H.traffic(H.workload(BENCH, name)["traffic"])["kind"]
    _faults(kind, monkeypatch)[fault]()
    res = _run(name)
    assert not res["correct"], res["compared"]


def test_window_counts_whole_units():
    log = []

    class Cell:
        def launch(self, u):
            log.append(("launch", u))
            time.sleep(0.02)
            return u

        def drain(self, h, u):
            assert h == u
            log.append(("drain", u))

    units, window_s = H.run_window(Cell(), 0.1, 10 ** 9, H.Ranges(False),
                                   lambda: None)
    assert window_s >= 0.1
    assert log.count(("drain", units - 1)) == 1
    assert sum(1 for k, _ in log if k == "launch") == units
    # one unit in flight ahead: u+1 is launched before u drains
    for u in range(units - 1):
        assert log.index(("launch", u + 1)) < log.index(("drain", u))


class _FakeProf:
    def __init__(self, events):
        self.events = events

    def export_chrome_trace(self, path):
        with open(path, "w") as f:
            json.dump({"traceEvents": self.events}, f)


def test_trace_summary_reads_busy_and_idle(tmp_path):
    ev = [
        {"cat": "user_annotation", "name": H.WINDOW, "ts": 0, "dur": 100},
        {"cat": "user_annotation", "name": "bb.launch", "ts": 0, "dur": 30},
        {"cat": "user_annotation", "name": "bb.drain", "ts": 60, "dur": 40},
        {"cat": "kernel", "name": "k1", "ts": 10, "dur": 20},
        {"cat": "kernel", "name": "k2", "ts": 20, "dur": 20},
        {"cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 70, "dur": 10},
        {"cat": "kernel", "name": "late", "ts": 150, "dur": 10},
    ]
    s = H.trace_summary(_FakeProf(ev), ("bb.launch", "bb.drain"),
                        str(tmp_path / "t.json"))
    assert s["window_s"] == pytest.approx(100e-6)
    assert s["busy_s"] == pytest.approx(40e-6)  # [10, 40] and [70, 80]
    assert s["kernels"] == 2
    idle = dict(s["idle_gaps"])
    assert idle["bb.launch"] == pytest.approx(10e-6)   # [0, 10]
    assert idle["bb.drain"] == pytest.approx(30e-6)    # [60,70], [80,100]
    assert idle["outside_the_harness_ranges"] == pytest.approx(20e-6)
    assert not os.path.exists(tmp_path / "t.json")


def test_forbidden_modules_compare_whole_top_level_names():
    got = H.forbidden_modules(["jax", "jax.numpy", "jaxlib", "flax.linen",
                               "xfr_tpu", "xfr_tpu.graph", "xfr_torch",
                               "xfr_torch.ops", "jaxtyping", "xfr_tpux"])
    assert got == ["flax.linen", "jax", "jax.numpy", "jaxlib", "xfr_tpu",
                   "xfr_tpu.graph"]


def test_reference_imports_nothing_of_the_program():
    code = ("import sys\n"
            "import xfr_bench.reference.strise, "
            "xfr_bench.reference.evaluation, "
            "xfr_bench.reference.lightcnn29_v2\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('xfr_torch', 'xfr_tpu', 'jax', 'jaxlib', 'flax')]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)


def test_no_result_without_a_card_or_without_the_program(tmp_path):
    shutil.copytree(os.path.join(ROOT, "xfr_bench"), tmp_path / "xfr_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    for cwd in (ROOT, tmp_path):
        p = subprocess.run(
            [sys.executable, "-m", "xfr_bench.run", "--workload",
             "r101.strise", "--seed", "5", "--seconds", "1", "--trace", "0"],
            cwd=cwd, capture_output=True, text=True, timeout=300)
        assert p.returncode != 0
        assert '"correct"' not in p.stdout


@pytest.mark.cuda
@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_control_is_not_correct(name):
    """The reference one precision below the configuration's, put in the
    program's place at the cell's own size, fails the cell's limits."""
    if not torch.cuda.is_available():
        pytest.skip("the control runs at the cell's size on a CUDA card")
    from xfr_bench.readings import control

    numbers = control(H.workload(BENCH, name), 2 ** 33 + 5)
    ok, shown = H.verdict(numbers, H.limits(name))
    assert not ok, shown
