"""Parameter conversion: torch state_dicts and JAX params into the port's
params (port of xfr_tpu/models/convert.py).

Model builders name their parameters by the exact torch state_dict
prefixes, so conversion is mechanical: conv/linear map weight/bias -> w/b,
batchnorm maps weight/bias/running_mean/running_var -> gamma/beta/mean/var.
"""

from __future__ import annotations

import numpy as np
import torch


def _np_of(v):
    if hasattr(v, "detach"):
        v = v.detach().cpu().numpy()
    return np.asarray(v)


def _key_map(shapes):
    if "gamma" in shapes:  # batchnorm
        return {"gamma": "weight", "beta": "bias",
                "mean": "running_mean", "var": "running_var"}
    return {"w": "weight", "b": "bias"}


def params_from_state_dict(param_shapes, state_dict, dtype=torch.float32,
                           strict=True, runtime_init=(), device="cuda"):
    """Build the params dict for a graph from a torch state_dict mapping.

    Args:
      param_shapes: GraphBuilder.param_shapes of the target graph.
      state_dict: mapping of torch parameter names to tensors/arrays.
      strict: verify shapes match the template.
      runtime_init: pnames the reference constructs at runtime rather than
        storing in the checkpoint — when absent from the state_dict they
        are deterministically initialized instead of raising.
      device: where the returned tensors live; "cuda" raises without a
        card.
    """
    from xfr_torch.models import common
    from xfr_torch.utils.device import resolve_device

    device = resolve_device(device)
    params = {}
    for pname, shapes in param_shapes.items():
        key_map = _key_map(shapes)
        if pname in runtime_init and not all(
                f"{pname}.{key_map[k]}" in state_dict for k in shapes):
            p = common.init_params({pname: shapes}, seed=0, dtype=dtype)
            params[pname] = {k: v.to(device) for k, v in p[pname].items()}
            continue
        p = {}
        for key in shapes:
            sd_key = f"{pname}.{key_map[key]}"
            if sd_key not in state_dict:
                raise KeyError(
                    f"checkpoint missing '{sd_key}' for param '{pname}'")
            arr = _np_of(state_dict[sd_key])
            if strict and tuple(arr.shape) != tuple(shapes[key]):
                raise ValueError(
                    f"shape mismatch for {sd_key}: checkpoint "
                    f"{arr.shape} vs template {shapes[key]}")
            p[key] = torch.as_tensor(arr, dtype=dtype, device=device)
        params[pname] = p
    return params


def params_from_jax(np_params, device="cuda", dtype=None):
    """The JAX package's params pytree ({pname: {key: array}}, as numpy or
    anything ``np.asarray`` takes) -> the port's params on ``device``.
    ``dtype`` None keeps each array's own type.  This is how weights are
    carried across from the reference."""
    from xfr_torch.utils.device import resolve_device

    dev = resolve_device(device)
    return {pname: {k: torch.as_tensor(np.array(v), dtype=dtype, device=dev)
                    for k, v in p.items()}
            for pname, p in np_params.items()}


def load_torch_checkpoint(path, strip_prefix=None, key="state_dict"):
    """torch.load a checkpoint file, optionally unwrapping a DataParallel
    'module.' prefix."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(ckpt, dict) and key in ckpt:
        ckpt = ckpt[key]
    if strip_prefix:
        ckpt = {(k[len(strip_prefix):] if k.startswith(strip_prefix) else k):
                v for k, v in ckpt.items()}
    return ckpt
