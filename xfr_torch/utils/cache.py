"""Content-keyed memo helpers (port of the memo part of
xfr_tpu/utils/cache.py; the npz result cache waits for the eval stage)."""

from __future__ import annotations

import hashlib

import numpy as np


def content_key(arr):
    """Content-hash memo key for a host array: (shape, dtype, blake2b).

    Shared by the blackbox embedding memos (blackbox/strise.py) so every
    content-keyed cache in the package computes keys one way."""
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
