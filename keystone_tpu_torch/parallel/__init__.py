"""Device meshes, the data-parallel placement helpers, the multi-process
layer (:mod:`.multihost`), the collectives of tensor and sequence
parallelism (:mod:`.collectives`) and GPipe pipeline parallelism
(:mod:`.pipeline_parallel`)."""

from keystone_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    create_mesh,
    current_mesh,
    data_axis_size,
    data_group,
    data_sharding,
    data_sharding_fn,
    model_sharding,
    pad_batch,
    process_mesh,
    replicated_sharding,
    shard_batch,
    shard_chunk_size,
    use_mesh,
)
from keystone_tpu_torch.parallel.multihost import GlobalRows, global_batch_from_local
from keystone_tpu_torch.parallel.pipeline_parallel import gpipe

__all__ = [
    "GlobalRows",
    "DATA_AXIS",
    "MODEL_AXIS",
    "Mesh",
    "create_mesh",
    "current_mesh",
    "data_axis_size",
    "data_group",
    "data_sharding",
    "data_sharding_fn",
    "global_batch_from_local",
    "gpipe",
    "model_sharding",
    "pad_batch",
    "process_mesh",
    "replicated_sharding",
    "shard_batch",
    "shard_chunk_size",
    "use_mesh",
]
