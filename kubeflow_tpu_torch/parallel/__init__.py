"""Parallelism: logical-axis sharding rules, the collectives of sharded
training, and sequence-parallel attention (port of
``kubeflow_tpu/parallel``; ``pipeline.py`` is not ported yet).

Mesh axes come from ``runtime.mesh``; this package maps logical tensor
axes onto them (``sharding``), moves shards between processes with
autograd-aware collectives (``collectives``) and runs ring and Ulysses
attention over the ``seq`` axis (``ring_attention``).
"""

from kubeflow_tpu_torch.parallel.sharding import (
    DEFAULT_RULES,
    LogicalRules,
    logical_to_mesh_axes,
    shard_params,
    with_logical_constraint,
)

__all__ = [
    "DEFAULT_RULES",
    "LogicalRules",
    "logical_to_mesh_axes",
    "shard_params",
    "with_logical_constraint",
]
