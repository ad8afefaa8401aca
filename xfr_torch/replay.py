"""The one place that decides whether a forward runs eagerly or replays a
captured CUDA graph (``run``).

A replay runs no Python, so while a graph is captured ``utils.profiling``
records the counts and kernel launches its function makes, and every
replay makes them again: a replayed forward counts what the eager one
counts.  The graphs live in one cache per owner (the ``GraphDef`` a
forward walks; dropped with it), keyed by ``Key``.
"""

from __future__ import annotations

import weakref
from typing import NamedTuple

import torch

from xfr_torch.utils import profiling

_caches = weakref.WeakKeyDictionary()


class Key(NamedTuple):
    """What a captured graph bakes in besides its function: the input's
    layout, the device, the flags ``precision()`` reads, the addresses of
    the parameter tensors it reads and a tag naming what it computes."""
    shape: tuple
    dtype: torch.dtype
    stride: tuple
    device: torch.device
    precision: tuple
    params: tuple
    tag: object


class Captured:
    """``fn`` of the static input buffer ``x``, captured once as a CUDA
    graph on a side stream with its own memory pool, after one eager
    warm-up there (cuDNN's and cuBLAS's handles, plans and workspaces are
    made outside the capture; the warm-up counts as an eager call).
    ``replay()`` runs the graph's kernels again on the current stream, on
    what ``x`` holds then, makes the counts and launches recorded while
    it was captured (``counts``), and returns the static output ``y``,
    which the next replay overwrites.  The graph reads the parameters at
    the addresses they had when it was captured.  Capturing waits once
    for the card; a replay waits for nothing."""

    def __init__(self, fn, x):
        with torch.cuda.device(x.device):
            main = torch.cuda.current_stream()
            side = torch.cuda.Stream()
            side.wait_stream(main)
            with torch.cuda.stream(side):
                fn(x)
            main.wait_stream(side)
            self.x = x
            self.graph = torch.cuda.CUDAGraph()
            with profiling.recording() as self.counts, \
                    torch.cuda.graph(self.graph):
                self.y = fn(x)

    def replay(self):
        self.graph.replay()
        profiling.emit(self.counts)
        return self.y


def engages(device):
    """Whether forwards on ``device`` replay a graph: on a card only."""
    return device.type == "cuda"


def precision():
    """The flags that choose a float32 convolution's and matrix product's
    kernels (``utils.device.precision_scope`` sets them)."""
    cudnn = torch.backends.cudnn
    return (torch.backends.cuda.matmul.allow_tf32, cudnn.allow_tf32,
            cudnn.deterministic, cudnn.benchmark)


def graphs(owner):
    """``owner``'s cache: {Key: Captured}."""
    got = _caches.get(owner)
    if got is None:
        got = _caches[owner] = {}
    return got


def clear(owner):
    """Drop ``owner``'s graphs."""
    _caches.pop(owner, None)


def run(fn, x, owner, tag, ids):
    """``fn(x)``.  On a card: ``owner``'s graph of ``fn`` for ``x``'s key,
    captured on a miss, with ``x`` copied into its input and replayed;
    the caller uses or copies the static output on the same stream before
    the next replay.  ``ids`` iterates over the addresses of the parameter
    tensors ``fn`` reads; it is read on a card only.  A key of ``tag``
    with other ``ids`` (the parameters were replaced) drops that tag's
    graphs of the old ones."""
    if not engages(x.device):
        return fn(x)
    cache = graphs(owner)
    key = Key(tuple(x.shape), x.dtype, x.stride(), x.device, precision(),
              tuple(ids), tag)
    got = cache.get(key)
    if got is None:
        for k in [k for k in cache if k.tag == tag and k.params != key.params]:
            del cache[k]
        got = cache[key] = Captured(fn, torch.empty_strided(
            key.shape, key.stride, dtype=x.dtype, device=x.device).zero_())
    got.x.copy_(x)
    return got.replay()
