"""Tracing/profiling helpers (port of xfr_tpu/utils/profiling.py).

``Timer`` accumulates host wall-clock time per key.  ``device_trace``
records a ``torch.profiler`` trace (the CPU, and the card when there is
one), where the JAX package uses ``jax.profiler``: the trace file goes to
``logdir`` for tensorboard or perfetto.
"""

from __future__ import annotations

import contextlib
import time


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
    ``*.pt.trace.json`` file; yields the profiler (``key_averages()``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, \
        tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(logdir)) as prof:
        yield prof
