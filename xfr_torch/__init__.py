"""xfr_torch: the PyTorch / CUDA port of xfr_tpu for one NVIDIA H100.

Mirrors ``xfr_tpu`` module by module and keeps its public names.  The JAX
package stays the reference: every ported module is held against it by
the ``tests/test_torch_*.py`` parity tests.  The port imports neither JAX
nor anything of ``xfr_tpu``.

Entry points take an explicit ``device`` (default ``"cuda"``) and raise
when no card is present unless the caller passed ``device="cpu"``.
Kernels that the JAX package wrote in Pallas for the TPU are CUDA C++
sources under ``xfr_torch/csrc/``, built by ``nvcc`` at first use.

Ported so far: the STRise blackbox saliency path (graph IR, ops,
ResNet-101+L2, the single EBP walk, masks, the fused mask-blend kernel and
the scorer).  ROADMAP.md lists what is still to be ported.
"""

import os

__version__ = "0.1.0"

# Repo root (directory containing the xfr_torch package).
xfr_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
