"""Multi-process coordination and device meshes (port of
xfr_tpu/parallel): ``distributed`` and ``mesh``."""

from xfr_torch.parallel.mesh import (  # noqa: F401
    make_mesh, shard_batch, replicate, data_sharding)
