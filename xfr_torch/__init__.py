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
ResNet-101+L2, the single EBP walk, masks, the fused mask-blend kernel,
the scorer and the gallery montage), the whitebox 4-map mix and the rest
of the whitebox API, the other matchers, the inpainting game's generation
stage (the per-probe weighted-subtree path, the generators, the dataset
filter, the match-threshold calibration and their CLIs) and its
evaluation stage (protocol, blend+encode, analysis, the ``run_eval`` and
``hiding_game`` CLIs), the Faster R-CNN face detector (``detection``),
``data.transforms``, ``strface``, the ``eccv20`` figures (with
``--use-detector``), ``unpack_dataset``, ``utils.{params, misc,
profiling}``, the triplet loader (``data.triplet``), fine-tuning
(``train``) and ``parallel`` (process coordination, and a
``torch.distributed`` device mesh with one process per card), and the
inference side's mesh forms (``Whitebox.use_mesh``, ``STRise(mesh=)``, the
generators' ``mesh=``, the CLIs' ``--mesh``): every rank of the group
runs the same calls, computes its rows and gathers them; and the two
demos (``python -m xfr_torch.demo.whitebox``, ``.blackbox``).

One input gives one result on the card, as on the TPU: the backward
walks sum in a fixed order, cuDNN runs deterministic algorithms inside
``utils.device.precision_scope``, and STRise draws its masks on the host,
so one seed gives one mask set on every device.

Not applicable, so not ported: the XLA compile cache
(``xfr_tpu.__init__._enable_persistent_compile_cache``, ``cli/warm_cache``
and the program registry ``utils/programs``) — torch compiles nothing
ahead of a call here, and a CUDA kernel is built once by ``kernels.load``
— and the JAX package's compile-and-dry-run hook ``__graft_entry__.py``,
whose part ``chip_smoke.py`` plays for the port.

Path conventions mirror the JAX package's (the same environment
overrides).
"""

import os

__version__ = "0.1.0"

# Repo root (directory containing the xfr_torch package).
xfr_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Dataset locations (overridable via environment).
inpaintgame_dir = os.environ.get(
    "XFR_INPAINTGAME_DIR", os.path.join(xfr_root, "data", "inpainting-game"))
inpaintgame2_dir = inpaintgame_dir
inpaintgame_saliencymaps_dir = os.environ.get(
    "XFR_INPAINTGAME_SMAPS_DIR",
    os.path.join(xfr_root, "data", "inpainting-game-saliency-maps"))
output_dir = os.environ.get("XFR_OUTPUT_DIR", os.path.join(xfr_root, "output"))
