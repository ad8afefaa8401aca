"""The benchmark's machinery, shared by every cell: files found by name,
seeded weights and draws, the measured window, the trace and its
reduction, and the comparison's verdict.

A cell is a configuration (``configs/<name>.json``, its program adapter
``configs/<name>.py`` and its plain reference ``reference/<name>.py``,
whose ``calibrate``, where it has one, ``weights`` applies; its images
are drawn at ``image_hw``) under a traffic mix (``traffic/<name>.json``), whose ``kind`` names the
general driver in ``kinds/<kind>.py``; each per-layer metric is a reader
``metrics/<name>.py``; each cell's correctness limits are
``limits/<workload>.json``.  Adding any of them adds a file and an entry
in ``BENCHMARK.json``; no file here changes.
"""

from __future__ import annotations

import contextlib
import importlib
import importlib.util
import json
import math
import os
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# Published dense peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, at
# the 700 W limit), FLOP/s by the precision a stage computes in.
PEAK_FLOPS = {"float32": 67e12, "tf32": 495e12, "bfloat16": 989e12}

# Top-level modules that may not be loaded in a benchmark process.
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "xfr_tpu")


def read_json(*parts):
    with open(os.path.join(HERE, *parts)) as f:
        return json.load(f)


def benchmark(root):
    """``BENCHMARK.json`` at the checkout's root."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def workload(bench, name):
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"xfr_bench: no workload {name!r} in BENCHMARK.json")


def _module(*parts):
    """The module of the file ``parts`` under this folder."""
    path = os.path.join(HERE, *parts)
    name = "xfr_bench._by_name." + "_".join(parts).replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def config(name):
    """The configuration's sizes, with ``program`` (its adapter,
    ``configs/<name>.py``) and ``reference`` (its plain reference,
    ``reference/<reference_module>.py``)."""
    cfg = read_json("configs", f"{name}.json")
    cfg["program"] = _module("configs", f"{name}.py")
    cfg["reference"] = importlib.import_module(
        f"xfr_bench.reference.{cfg['reference_module']}")
    return cfg


def traffic(name):
    return read_json("traffic", f"{name}.json")


def kind(name):
    return importlib.import_module(f"xfr_bench.kinds.{name}")


def limits(workload_name):
    """{number: limit} of a cell, or {} where none is set yet."""
    path = os.path.join(HERE, "limits", f"{workload_name}.json")
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        return {k: v["limit"] for k, v in json.load(f)["numbers"].items()}


def metric_reader(name):
    """``read(run)`` of ``metrics/<name>.py``: a number, or None where
    the run holds nothing for it to read."""
    return _module("metrics", f"{name}.py").read


def derive(seed, *tags):
    """A 31-bit seed for one purpose (``tags``) of a run's ``seed``; any
    whole number is a valid ``seed``."""
    words = [int(seed) % 2**64] + [
        t if isinstance(t, int) else int.from_bytes(t.encode(), "little")
        % 2**64 for t in tags]
    return int(np.random.SeedSequence(words).generate_state(1)[0]) >> 1


def generator(seed, device, *tags):
    import torch

    g = torch.Generator(device=device)
    g.manual_seed(derive(seed, *tags))
    return g


def make_weights(shapes, seed, device):
    """Random float32 weights for a {name: {key: shape}} template, made on
    ``device`` from ``seed`` in two draws: He-style convolutions and
    linear layers (std sqrt(2 / fan_out)), biases 0.01·N, BatchNorm near
    identity (gamma 1 + 0.1·N, beta and mean 0.05·N, var uniform in
    [0.5, 1)), as the program's own random init draws them."""
    import torch

    leaves = [(n, k, tuple(s)) for n in shapes for k, s in shapes[n].items()]
    sizes = [math.prod(s) for _, _, s in leaves]
    g = generator(seed, device, "weights")
    normal = torch.randn(sum(sizes), generator=g, device=device)
    uniform = torch.rand(sum(sizes), generator=g, device=device)
    out, at = {}, 0
    for (name, key, shape), n in zip(leaves, sizes):
        z = normal[at:at + n].view(shape)
        if key == "w":
            fan_out = shape[0] * (math.prod(shape[2:]) if len(shape) > 2
                                  else 1)
            v = z * math.sqrt(2.0 / fan_out)
        elif key == "b":
            v = z * 0.01
        elif key == "gamma":
            v = 1.0 + 0.1 * z
        elif key in ("beta", "mean"):
            v = 0.05 * z
        elif key == "var":
            v = 0.5 + 0.5 * uniform[at:at + n].view(shape)
        else:
            raise KeyError(key)
        out.setdefault(name, {})[key] = v.clone()
        at += n
    return out


def image_hw(cfg):
    """(H, W) of the images the traffic draws and STRise masks: the
    configuration's optional ``image_hw``, by default its input's; the
    reference's ``preprocess`` takes them to ``input_chw``."""
    return tuple(cfg.get("image_hw", cfg["input_chw"][1:]))


def images(seed, device, tag, n, hw):
    """``n`` uint8 RGB images [n, H, W, 3] on ``device``, drawn from the
    seed under ``tag``."""
    import torch

    return torch.randint(0, 256, (n,) + tuple(hw) + (3,),
                         generator=generator(seed, device, tag),
                         device=device, dtype=torch.uint8)


def weights(cfg, seed, device):
    """The configuration's weights, the same for program and reference:
    the one seam through which every kind gets its matcher's weights.
    ``make_weights`` of the reference's ``param_shapes``, then, where the
    reference defines ``calibrate(params, cfg, images)``, that call, which
    changes ``params`` in place, on ``calibration_images`` uint8 images
    drawn from the seed under "gates" at ``image_hw``.  A configuration
    whose plain random init does not compute as a trained net does
    (SENet's saturated gates, BatchNorm statistics that do not fit the
    data) sets that right in its ``calibrate``."""
    R = cfg["reference"]
    params = make_weights(R.param_shapes(cfg), seed, device)
    if hasattr(R, "calibrate"):
        R.calibrate(params, cfg, images(
            seed, device, "gates", cfg["calibration_images"], image_hw(cfg)))
    return params


def same_template(shapes, params):
    """Raise unless the program's {name: {key: shape}} template names the
    same leaves, of the same shapes, as the weights made for the
    reference."""
    got = {(n, k, tuple(s)) for n, ks in shapes.items() for k, s in ks.items()}
    want = {(n, k, tuple(v.shape)) for n, ks in params.items()
            for k, v in ks.items()}
    if got != want:
        raise ValueError("the program's parameter template differs from the "
                         f"reference's: {sorted(got ^ want)[:6]}")


class Ranges:
    """The harness's named host ranges around its calls into the program,
    recorded by the profiler when the run is traced."""

    def __init__(self, traced):
        self.traced = traced

    def __call__(self, name):
        if not self.traced:
            return contextlib.nullcontext()
        import torch

        return torch.profiler.record_function(name)


WINDOW = "xfr_bench.window"


def run_window(cell, seconds, max_units, ranges, sync):
    """Closed loop with one unit in flight ahead: launch unit u+1, then
    drain unit u.  Launching stops at the first drain after ``seconds``
    (or after ``max_units`` units); the window closes when every launched
    unit has drained.  Returns (units, window seconds)."""
    sync()
    with ranges(WINDOW):
        t0 = time.perf_counter()
        pend, u = cell.launch(0), 0
        while True:
            more = time.perf_counter() - t0 < seconds and u + 1 < max_units
            nxt = cell.launch(u + 1) if more else None
            cell.drain(pend, u)
            if nxt is None:
                break
            pend, u = nxt, u + 1
        window_s = time.perf_counter() - t0
    return u + 1, window_s


DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def trace_summary(prof, range_names, path):
    """Reduce a profiler run to what the per-layer readers and the
    breakdown need: the window's length, the device's busy seconds in it
    (the union of every kernel's and copy's interval), the kernels
    launched, the device time by operation name, and the idle gaps by the
    harness range the host was in.  The trace goes through a Chrome trace
    file at ``path``, which is removed."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    prof.export_chrome_trace(path)
    try:
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    win = [e for e in events if e.get("cat") == "user_annotation"
           and e.get("name") == WINDOW]
    if len(win) != 1:
        raise RuntimeError(f"the trace holds {len(win)} windows")
    t0, t1 = win[0]["ts"], win[0]["ts"] + win[0]["dur"]
    starts, ends, names, ranges = [], [], [], []
    for e in events:
        cat = e.get("cat")
        if cat in DEVICE_CATEGORIES:
            a, b = max(e["ts"], t0), min(e["ts"] + e["dur"], t1)
            if b > a:
                starts.append(a)
                ends.append(b)
                names.append(e["name"])
        elif cat == "user_annotation" and e.get("name") in range_names:
            ranges.append((e["name"], e["ts"], e["ts"] + e["dur"]))
    del events
    if not starts:
        raise RuntimeError("the trace holds no device operation in the "
                           "window")
    starts, ends = np.asarray(starts, float), np.asarray(ends, float)
    order = np.argsort(starts, kind="stable")
    s, e = starts[order], ends[order]
    run_end = np.maximum.accumulate(e)
    new = np.ones(len(s), bool)
    new[1:] = s[1:] > run_end[:-1]
    idx = np.flatnonzero(new)
    m_start = s[idx]
    m_end = np.append(run_end[idx[1:] - 1], run_end[-1])
    busy = float((m_end - m_start).sum())
    gap_a = np.append(t0, m_end)
    gap_b = np.append(m_start, t1)
    keep = gap_b > gap_a
    gap_a, gap_b = gap_a[keep], gap_b[keep]
    idle = {}
    for name, a, b in ranges:
        ov = np.clip(np.minimum(gap_b, b) - np.maximum(gap_a, a), 0, None)
        idle[name] = idle.get(name, 0.0) + float(ov.sum()) / 1e6
    total_idle = float((gap_b - gap_a).sum()) / 1e6
    idle["outside_the_harness_ranges"] = max(
        0.0, total_idle - sum(idle.values()))
    by_op = {}
    for n, a, b in zip(names, starts, ends):
        by_op[n] = by_op.get(n, 0.0) + (b - a) / 1e6
    kernels = sum(1 for n in names
                  if not n.startswith(("Memcpy", "Memset")))
    return {"window_s": (t1 - t0) / 1e6, "busy_s": busy / 1e6,
            "kernels": kernels,
            "device_ops": sorted(by_op.items(), key=lambda kv: -kv[1])[:10],
            "idle_gaps": sorted(idle.items(), key=lambda kv: -kv[1])[:10]}


def pick(tr, seed, units):
    """The window's units compared with the reference: ``check_units`` of
    them drawn from the seed."""
    rng = np.random.RandomState(derive(seed, "check"))
    return sorted(int(u) for u in rng.choice(
        units, min(units, tr["check_units"]), replace=False))


def forbidden_modules(modules):
    """Loaded modules whose top-level name (before the first dot) is one
    of ``FORBIDDEN_MODULES``, compared as whole names."""
    return sorted(m for m in modules
                  if m.split(".", 1)[0] in FORBIDDEN_MODULES)


def verdict(numbers, lims):
    """(correct, {name: {"value", "limit"}}): correct when every number
    has a limit and lies at or below it."""
    shown = {k: {"value": v, "limit": lims.get(k)} for k, v in
             numbers.items()}
    ok = bool(numbers) and all(
        lims.get(k) is not None and v <= lims[k] for k, v in numbers.items())
    return ok, shown
