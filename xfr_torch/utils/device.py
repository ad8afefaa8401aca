"""Device placement and float32 precision scopes.

Every entry point of the port takes an explicit ``device`` that defaults
to ``"cuda"``.  A CUDA device without a card raises: the port never falls
back to the CPU on its own.
"""

from __future__ import annotations

import contextlib
import subprocess

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


def to_device(t, device):
    """``t`` on ``device``: a host tensor goes to a card as a pinned copy
    that does not wait for the card.  ``pin_memory`` copies ``t`` into a
    new pinned buffer, which the caching host allocator keeps alive until
    the upload has run, so the caller may overwrite ``t`` at once."""
    device = torch.device(device)
    if t.device.type == "cpu" and device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def card_name_and_power_limit():
    """The first card's ``{"name", "power_limit"}`` as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them
    ("NVIDIA H100 80GB HBM3", "700.00 W"): a measurement on the card is
    reported beside them."""
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    name, power_limit = line.rsplit(",", 1)
    return {"name": name.strip(), "power_limit": power_limit.strip()}


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
