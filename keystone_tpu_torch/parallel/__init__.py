"""Device meshes for the sequence-parallel paths and the data-parallel
placement helpers."""

from keystone_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    create_mesh,
    current_mesh,
    data_axis_size,
    data_sharding,
    pad_batch,
    shard_batch,
    shard_chunk_size,
    use_mesh,
)

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "Mesh",
    "create_mesh",
    "current_mesh",
    "data_axis_size",
    "data_sharding",
    "pad_batch",
    "shard_batch",
    "shard_chunk_size",
    "use_mesh",
]
