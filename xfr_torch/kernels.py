"""Build and load the hand-written CUDA kernels under ``xfr_torch/csrc``.

Each ``csrc/<name>.cu`` has a plain C interface.  At first use it is
compiled by ``nvcc`` for ``sm_90a`` into a shared library under
``build/kernels/`` of the checkout (git-ignored), keyed by the hash of the
source and the flags, and loaded with ``ctypes``.  A missing ``nvcc`` or a
failed build raises.  Nothing is built when a module is imported.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess

from xfr_torch import xfr_root

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(xfr_root, "build", "kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
NVCC_DEFAULT = "/usr/local/cuda/bin/nvcc"


def _nvcc():
    path = shutil.which("nvcc") or NVCC_DEFAULT
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build the xfr_torch kernels")
    return path


def library_path(name):
    """Path of the built library for ``csrc/<name>.cu`` at its current
    source (built or not)."""
    with open(os.path.join(CSRC, name + ".cu"), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")


@functools.cache
def load(name):
    """The ctypes library of ``csrc/<name>.cu``, built by ``nvcc`` if no
    library of the current source exists yet."""
    path = library_path(name)
    if not os.path.exists(path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"  # never leave a half-written .so
        src = os.path.join(CSRC, name + ".cu")
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed to build {name}.cu (exit "
                               f"{proc.returncode}):\n{proc.stdout}")
        os.replace(tmp, path)
    return ctypes.CDLL(path)
