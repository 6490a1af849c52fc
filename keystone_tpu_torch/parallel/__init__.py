"""Device meshes for the sequence-parallel paths, the data-parallel
placement helpers and the multi-process layer (:mod:`.multihost`)."""

from keystone_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    create_mesh,
    current_mesh,
    data_axis_size,
    data_sharding,
    data_sharding_fn,
    pad_batch,
    replicated_sharding,
    shard_batch,
    shard_chunk_size,
    use_mesh,
)
from keystone_tpu_torch.parallel.multihost import GlobalRows, global_batch_from_local

__all__ = [
    "GlobalRows",
    "DATA_AXIS",
    "MODEL_AXIS",
    "Mesh",
    "create_mesh",
    "current_mesh",
    "data_axis_size",
    "data_sharding",
    "data_sharding_fn",
    "global_batch_from_local",
    "pad_batch",
    "replicated_sharding",
    "shard_batch",
    "shard_chunk_size",
    "use_mesh",
]
