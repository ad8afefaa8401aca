"""Data pipelines (port of xfr_tpu/data): ``transforms``.  The triplet
loader (``xfr_tpu/data/triplet.py``) is not ported yet (ROADMAP.md)."""
