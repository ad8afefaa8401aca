"""Content-checked npz result cache and content-keyed memo helpers (port
of xfr_tpu/utils/cache.py).

The analysis passes of the inpainting game are resumable because every
expensive per-(net, subject, mask, probe, method) result is cached under a
parameter-slug filename with its defining inputs stored alongside — a cache
hit is only honored when the stored inputs match.
"""

from __future__ import annotations

import hashlib
import os
import pickle
import zipfile
from pathlib import Path

import numpy as np


def _cache_path(fn, cache_dir):
    Path(cache_dir).mkdir(parents=True, exist_ok=True)
    return os.path.join(cache_dir, fn.replace("/", "_") + ".npz")


# A cache MISS is any failure to produce a valid cached value: missing
# file, stale/absent keys, forced reprocess (IOError/KeyError), or a
# CORRUPT file — a run killed mid np.savez leaves a truncated zip that
# np.load raises zipfile.BadZipFile / EOFError / unpickling ValueError
# on, and a resumable cache must recompute those, not crash every resume
# until the file is hand-deleted.
_CACHE_MISS = (IOError, KeyError, FileNotFoundError, EOFError, ValueError,
               zipfile.BadZipFile, pickle.UnpicklingError)


def _cache_load(fpath, reprocess, save_dict):
    """Load a valid cached result or raise IOError/KeyError."""
    if reprocess:
        raise IOError  # force reprocessing
    npdata = np.load(fpath, allow_pickle=True)
    if save_dict is not None:
        for key, val in save_dict.items():
            if not np.array_equal(npdata[key], val):
                raise IOError  # stale cache: inputs changed
    return npdata["arr_0"]


def _cache_save(fpath, ret, save_dict):
    save_dict = dict(save_dict or {})
    # Ragged tuple results (e.g. (iou, fp, neg, tp, pos)) must be stored
    # as object arrays.  Convert BEFORE np.savez — a save that raises
    # mid-write leaves a corrupt zip.
    try:
        save_dict["arr_0"] = np.asanyarray(ret)
    except ValueError:
        arr = np.empty(len(ret), dtype=object)
        for i, v in enumerate(ret):
            arr[i] = v
        save_dict["arr_0"] = arr
    np.savez(fpath, **save_dict)


def cache_npz(fn, fun, cache_dir, *args, **kwargs):
    """Memoize ``fun(*args, **kwargs)`` into ``cache_dir/fn.npz``.

    kwargs:
      reprocess_: force recomputation.
      save_dict_: dict of arrays saved with (and validated against) the cache.
      write_: False computes a miss without writing it (the ranks of a
        device mesh other than the first).
    """
    fpath = _cache_path(fn, cache_dir)
    write = kwargs.pop("write_", True)
    try:
        return _cache_load(fpath, kwargs.get("reprocess_"),
                           kwargs.get("save_dict_"))
    except _CACHE_MISS:
        kwargs.pop("reprocess_", None)
        save_dict = kwargs.pop("save_dict_", {})
        ret = fun(*args, **kwargs)
        if write:
            _cache_save(fpath, ret, save_dict)
        return ret


def cache_npz_launch(fn, launch_fun, cache_dir, reprocess_=False,
                     save_dict_=None, write_=True, agree_=None):
    """Launch/finish variant of :func:`cache_npz` for overlapping device
    work with host work.  On a cache hit, returns a zero-arg finish that
    yields the cached value immediately.  On a miss, calls
    ``launch_fun()`` — which must return a zero-arg finish closure — NOW,
    and returns a finish that drains it and writes the cache (unless
    ``write_`` is False).

    ``agree_(hit) -> bool`` turns this process's hit into one every rank
    of a device mesh shares (an all-reduce): a launch whose finish joins
    collectives must run on every rank or on none."""
    fpath = _cache_path(fn, cache_dir)
    try:
        val = _cache_load(fpath, reprocess_, save_dict_)
    except _CACHE_MISS:
        val = None
    hit = val is not None
    if agree_ is not None:
        hit = agree_(hit)
    if hit:
        return lambda: val
    inner = launch_fun()

    def finish():
        ret = inner()
        if write_:
            _cache_save(fpath, ret, save_dict_)
        return ret

    return finish


def content_key(arr):
    """Content-hash memo key for a host array: (shape, dtype, blake2b).

    Shared by the device-upload memo (engine._device_put_memo) and the
    blackbox embedding memos (blackbox/strise.py) so every content-keyed
    cache in the package computes keys one way."""
    arr = np.ascontiguousarray(arr)
    return (arr.shape, str(arr.dtype),
            hashlib.blake2b(arr.tobytes(), digest_size=16).digest())


def memo_put(memo, key, value, cap=16):
    """Insert into a bounded dict memo (clear-all eviction at ``cap`` —
    the working sets are a handful of images) and return ``value``."""
    if len(memo) >= cap:
        memo.clear()
    memo[key] = value
    return value
