"""Small utilities (port of xfr_tpu/utils/misc.py)."""

from __future__ import annotations

import os
import shutil

import numpy as np


def set_default_print_env(var, default=None):
    """Set-and-echo an environment variable."""
    if default is not None and var not in os.environ:
        os.environ[var] = default
    if var in os.environ:
        print("%s=%s" % (var, os.environ[var]))
        return os.environ[var]
    print("%s=<not set>" % var)
    return None


def copy_files(paths, output_dir):
    """Copy files into a run directory with path-encoding names."""
    for path in paths:
        assert len(path) > 1, ("Make sure you pass a list of paths and not "
                               "a single string!")
        path = os.path.abspath(path)
        shutil.copy2(path, os.path.join(output_dir,
                                        path.replace("/", "%")))


def denormalize(x, std, mean):
    """Invert normalization and clamp to [0,1]."""
    return np.clip(np.asarray(x) * std + mean, 0.0, 1.0)


def init_random_seed(manual_seed=None):
    """Seed python's, numpy's and torch's global generators (torch's
    seeds every card as well); returns the seed."""
    import random

    import torch

    seed = manual_seed if manual_seed is not None else \
        random.randint(1, 10000)
    print("use random seed: {}".format(seed))
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return seed


def visible_devices():
    """The CUDA devices torch can use (empty without a card), where the
    JAX package lists ``jax.devices()``."""
    import torch

    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
