"""Device placement and float32 precision scopes.

Every entry point of the port takes an explicit ``device`` that defaults
to ``"cuda"``.  A CUDA device without a card raises: the port never falls
back to the CPU on its own.
"""

from __future__ import annotations

import contextlib

import torch


def resolve_device(device="cuda"):
    """``device`` (str, torch.device or None for ``"cuda"``) ->
    torch.device with its index ("cuda" becomes the current card, so that
    devices compare equal to those of the tensors placed there), raising
    when a CUDA device is asked for and no card is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "xfr_torch: no CUDA device is available; pass device='cpu' "
                "to run the plain PyTorch path on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@contextlib.contextmanager
def precision_scope(precision):
    """Float32 precision of convolutions and matrix products in a block.

    ``None`` allows TF32 (the fast default, like the TPU's single-pass
    bf16); ``"high"`` and ``"highest"`` run full float32.  Inside the
    scope cuDNN runs only deterministic algorithms, picked without
    benchmarking, so that a convolution and its gradients give the same
    bits on every run (its backward-data and weight-gradient algorithms
    may otherwise sum with atomics).  cuDNN's flags are scoped with
    ``torch.backends.cudnn.flags`` and the matmul flag is saved and
    restored, so nothing changes process-wide."""
    if precision not in (None, "high", "highest"):
        raise ValueError(f"unknown precision {precision!r}")
    tf32 = precision is None
    cudnn = torch.backends.cudnn
    matmul = torch.backends.cuda.matmul
    with cudnn.flags(enabled=cudnn.enabled, benchmark=False,
                     deterministic=True, allow_tf32=tf32):
        # set after entering cudnn.flags, which also resets torch's
        # newer per-backend fp32 precision setting for its scope
        saved = matmul.allow_tf32
        matmul.allow_tf32 = tf32
        try:
            yield
        finally:
            matmul.allow_tf32 = saved
