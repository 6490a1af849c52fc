"""Device meshes for the sequence-parallel paths."""

from keystone_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    create_mesh,
    current_mesh,
    use_mesh,
)

__all__ = ["DATA_AXIS", "MODEL_AXIS", "Mesh", "create_mesh", "current_mesh", "use_mesh"]
