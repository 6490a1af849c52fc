"""Tensor-parallel weight layout for the transformer LM — the part of
``keystone_tpu/models/lm/sharding.py`` that one card runs.

The JAX package shards each weight over the mesh ``model`` axis. The port
holds a whole model on each card: with no mesh, or a mesh whose ``model``
axis has one position (data parallelism keeps a replica per process),
:func:`shard_params` is the identity; a mesh that would shard the weights
raises until tensor parallelism (ROADMAP A6 part 2).
"""

from __future__ import annotations


def shard_params(model, mesh):
    """``model`` as it is when ``mesh`` would not shard its weights."""
    if mesh is None or mesh.shape.get("model", 1) == 1:
        return model
    raise NotImplementedError(
        f"shard_params over a model axis of {mesh.shape['model']}: tensor-parallel "
        "weights come with ROADMAP A6 part 2"
    )
