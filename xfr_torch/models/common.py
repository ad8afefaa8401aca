"""Shared model-zoo helpers: parameter initialization and placement.

Not ported from ``xfr_tpu/models/common.py``: ``init_params_device``
draws from the JAX PRNG, which torch cannot reproduce (the port's
factory uses the numpy ``init_params``), and ``cast_params`` is
``params_to(params, device, dtype=)`` here.
"""

from __future__ import annotations

import numpy as np
import torch


def init_params(param_shapes, seed=0, dtype=torch.float32, scale=None):
    """Random parameters for a GraphBuilder's param_shapes template, as CPU
    tensors.

    The same numpy draws as xfr_tpu.models.common.init_params, in the same
    order, so both packages give the same values bit for bit.  (The JAX
    package's on-device ``init_params_device`` uses the JAX PRNG, which
    torch cannot reproduce; the port's factory uses this numpy init.)
    Conv/linear weights get He-style init; BN is identity-ish with small
    perturbations so EBP denominators stay well-conditioned.
    """
    np_dtype = torch.empty((), dtype=dtype).numpy().dtype
    rng = np.random.RandomState(seed)
    params = {}
    for pname, shapes in param_shapes.items():
        p = {}
        for key, shp in shapes.items():
            if key == "w":
                fan_out = shp[0] * (np.prod(shp[2:]) if len(shp) > 2 else 1)
                std = scale or np.sqrt(2.0 / fan_out)
                v = rng.randn(*shp) * std
            elif key == "b":
                v = rng.randn(*shp) * 0.01
            elif key == "gamma":
                v = 1.0 + 0.1 * rng.randn(*shp)
            elif key == "beta":
                v = 0.05 * rng.randn(*shp)
            elif key == "mean":
                v = 0.05 * rng.randn(*shp)
            elif key == "var":
                v = 0.5 + 0.5 * rng.rand(*shp)
            else:
                raise KeyError(key)
            p[key] = torch.from_numpy(np.asarray(v, np_dtype))
        params[pname] = p
    return params


def params_to(params, device, dtype=None):
    """Move (and optionally cast) a {pname: {key: tensor}} params dict."""
    return {k: {kk: vv.to(device=device, dtype=dtype or vv.dtype)
                for kk, vv in v.items()}
            for k, v in params.items()}
