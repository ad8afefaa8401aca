"""Tracing/profiling helpers (port of xfr_tpu/utils/profiling.py).

``Timer`` accumulates host wall-clock time per key.  ``device_trace``
records a ``torch.profiler`` trace (the CPU, and the card when there is
one), where the JAX package uses ``jax.profiler``: the trace file goes to
``logdir`` for tensorboard or perfetto.

``span`` and ``count`` are the program's own spans and counters at its
layer boundaries.  They are live exactly while a ``torch.profiler``
records in the process (``device_trace``, or any other profiler): a span
is then a ``record_function`` range, so it lands in the trace as a
``user_annotation`` event on the clock of the kernels and copies, nested
in the span that encloses it on the same thread.  While they are live,
``span_seconds()`` totals each span's host seconds and ``counters()``
each counter.  With no profiler recording, each costs one check: ``span``
returns one shared null context and ``count`` returns at once.

A captured CUDA graph runs no Python when it is replayed, so inside
``recording()`` (around a capture, ``replay.Captured``) ``count`` and
``launched`` record what they would add, and ``emit`` adds it at each
replay.
"""

from __future__ import annotations

import contextlib
import time

import torch
from torch._C._autograd import _profiler_enabled

_NULL = contextlib.nullcontext()
_counters = {}
_span_seconds = {}
_recording = None  # inside recording(): {counter name or wrapper: n}


class Timer:
    """Accumulating wall-clock timer with per-key stats.  Asynchronous
    CUDA work is timed only if the block ends in a synchronize."""

    def __init__(self):
        self.totals = {}
        self.counts = {}

    @contextlib.contextmanager
    def time(self, key):
        t0 = time.time()
        try:
            yield
        finally:
            dt = time.time() - t0
            self.totals[key] = self.totals.get(key, 0.0) + dt
            self.counts[key] = self.counts.get(key, 0) + 1

    def report(self):
        lines = []
        for k in sorted(self.totals):
            n = self.counts[k]
            lines.append("%-40s %8.3fs total  %8.1f ms/call  (%d calls)"
                         % (k, self.totals[k],
                            1000 * self.totals[k] / max(n, 1), n))
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(logdir):
    """torch.profiler trace of the block, written to ``logdir`` as a
    ``*.pt.trace.json`` file; yields the profiler (``key_averages()``).
    The program's spans are in it."""
    from torch.profiler import ProfilerActivity, profile, \
        tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(logdir)) as prof:
        yield prof


class _Span:
    """A live span: a ``record_function`` range, its host seconds added
    to ``span_seconds()`` on exit."""

    __slots__ = ("name", "_range", "_t0")

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        self._range.__exit__(*exc)
        _span_seconds[self.name] = _span_seconds.get(self.name, 0.0) + dt
        return False


def span(name):
    """A context for the program step ``name``: a profiler range while a
    torch.profiler records, else the shared null context."""
    if not _profiler_enabled():
        return _NULL
    return _Span(name)


def count(name, n=1):
    """Add ``n`` to the counter ``name`` while a torch.profiler records;
    inside ``recording()``, record it instead."""
    if _recording is not None:
        _recording[name] = _recording.get(name, 0) + n
    elif _profiler_enabled():
        _counters[name] = _counters.get(name, 0) + n


def count_replays(name):
    """Add one to the counter ``name`` at each replay of the graph being
    captured (``recording()``); outside a capture, nothing."""
    if _recording is not None:
        _recording[name] = _recording.get(name, 0) + 1


def launched(fn):
    """Add one to ``fn.launches``, the launch counter of the kernel
    wrapper ``fn``; inside ``recording()``, record it instead."""
    if _recording is not None:
        _recording[fn] = _recording.get(fn, 0) + 1
    else:
        fn.launches += 1


@contextlib.contextmanager
def recording():
    """Record the block's ``count`` and ``launched`` calls instead of
    making them; yields their totals, {counter name or wrapper: n}, which
    ``emit`` makes."""
    global _recording
    outer, _recording = _recording, {}
    try:
        yield _recording
    finally:
        _recording = outer


def emit(recorded):
    """Make the calls ``recording()`` recorded: one replay's counts (while
    a torch.profiler records) and launches."""
    for what, n in recorded.items():
        if isinstance(what, str):
            count(what, n)
        else:
            what.launches += n


def counters():
    """{name: total} of every counter so far in this process."""
    return dict(_counters)


def span_seconds():
    """{name: host seconds} of every span so far in this process."""
    return dict(_span_seconds)
