"""Parameter checkpointing (port of xfr_tpu/models/checkpoint.py).

The JAX package stores its params pytree with Orbax; the port saves the
``{pname: {key: tensor}}`` params dict with ``torch.save``.  Torch
state_dict checkpoints of the reference nets load through
``xfr_torch.models.convert``.
"""

from __future__ import annotations

import os

import torch


def save_params(params, path):
    """Save a params dict to the file ``path``; returns its absolute path."""
    path = os.path.abspath(path)
    torch.save({k: dict(v) for k, v in params.items()}, path)
    return path


def load_params(path, template=None):
    """Load a params dict (onto the CPU).  With ``template`` (a params
    dict of the same keys) each tensor takes the template's dtype and
    device."""
    params = torch.load(os.path.abspath(path), map_location="cpu",
                        weights_only=True)
    if template is None:
        return params
    return {k: {kk: vv.to(device=template[k][kk].device,
                          dtype=template[k][kk].dtype)
                for kk, vv in v.items()}
            for k, v in params.items()}
