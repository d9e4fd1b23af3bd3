"""Data parallelism and spatial partitioning over processes, one per card
(counterpart of ``pytorch_cifar_tpu/parallel/``): the rendezvous and the
broadcasts in ``mesh``, the data-parallel step's collectives in ``dp``,
and the ``(data, spatial[, spatial_w])`` mesh with its halo exchanges in
``spatial``."""

from pytorch_cifar_tpu_torch.parallel.mesh import DATA_AXIS  # noqa: F401
from pytorch_cifar_tpu_torch.parallel.spatial import (  # noqa: F401
    SPATIAL_AXIS,
    SPATIAL_W_AXIS,
    SpatialMesh,
    SpatialPartition,
    halo_extend,
    make_spatial_mesh,
    rows_needed,
    shard_range,
    spatial_batch_sharding,
    spatial_label_sharding,
    spatial_partition,
)
