"""The port's demos (counterparts of the repo's ``demo/`` scripts):

    python -m xfr_torch.demo.whitebox [--quick] [--device cpu]
    python -m xfr_torch.demo.blackbox [--custom-bb] [--device cpu]

Each writes its overlays into ``--outdir`` (default: the repo's ``demo/``
directory, beside the JAX package's demos, under the same file names).
"""
