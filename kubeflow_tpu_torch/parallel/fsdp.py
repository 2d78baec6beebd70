"""Sharded train state over a mesh (the port's counterpart of the JAX
package's ``_state_shardings`` and GSPMD's FSDP/data-parallel
collectives).

``StateLayout`` holds, for one model's params, each leaf's placement
(``sharding.shard_params``: ``embed`` over ``fsdp``, which for most
leaves is not dim 0) and the process groups the step needs:

- ``fsdp``: a sharded leaf is all-gathered over it where it is used
  (``collectives.GatheredParams``) and its gradient reduce-scattered back;
- the replica axes: a sharded leaf's gradient is then summed over
  ``dcn``, ``data`` and ``seq`` (the ranks that hold the same shard), a
  replicated leaf's over every batch and ``seq`` axis.

The optimizer's moments mirror the params' placements, so Adam runs on
local shards; the global gradient norm sums each shard once
(``global_norm``). A ``model``, ``pipeline`` or ``expert`` degree above 1
raises: those axes are not ported yet.
"""

from __future__ import annotations

from typing import Any

import torch

from kubeflow_tpu_torch.parallel import collectives as C
from kubeflow_tpu_torch.runtime.mesh import batch_sharding_axes
from kubeflow_tpu_torch.parallel.sharding import (
    DEFAULT_RULES, LogicalRules, cut_local, mesh_coords, mesh_shape,
    shard_params, sharded_dim,
)
from kubeflow_tpu_torch.train import tree as T

#: Mesh axes the training step does not split yet.
UNPORTED_AXES = ("model", "pipeline", "expert")
#: The axes a batch is split over, and with ``seq`` every axis a step's
#: loss and replicated gradients are summed over.
BATCH_AXES = batch_sharding_axes()
TOKEN_AXES = BATCH_AXES + ("seq",)


def check_mesh(mesh) -> None:
    """Raise ``NotImplementedError`` for a ``model``, ``pipeline`` or
    ``expert`` degree above 1."""
    sizes = mesh_shape(mesh)
    big = {a: sizes[a] for a in UNPORTED_AXES if sizes.get(a, 1) > 1}
    if big:
        raise NotImplementedError(
            f"mesh axes {big}: the port trains over the dcn, data, fsdp and "
            "seq axes; tensor, pipeline and expert parallelism arrive with "
            "ROADMAP.md Queue 1 item 9")


def batch_index(mesh) -> tuple[int, int]:
    """(this rank's index over the batch axes, row-major; their degree):
    the data shard it reads. Ranks that differ only in ``seq`` read the
    same rows."""
    if mesh is None:
        return 0, 1
    sizes, coords = mesh_shape(mesh), mesh_coords(mesh)
    idx, deg = 0, 1
    for a in BATCH_AXES:
        idx = idx * sizes[a] + coords[a]
        deg *= sizes[a]
    return idx, deg


class StateLayout:
    """Placements and groups of one model's train state on ``mesh``,
    from its logical spec tree and the full (global) params, or tensors
    of their shapes (``meta`` tensors: nothing drawn)."""

    def __init__(self, mesh, logical_specs: Any, params: Any,
                 rules: LogicalRules = DEFAULT_RULES):
        check_mesh(mesh)
        self.mesh = mesh
        self.sizes = mesh_shape(mesh)
        self.coords = mesh_coords(mesh)
        self.specs = shard_params(params, logical_specs, mesh, rules)
        self._flat_specs = T.flatten(self.specs)
        self.dims = T.map_tree(lambda s: sharded_dim(s, self.sizes),
                               self.specs)
        # Every rank makes the groups here, in one order.
        self.fsdp_group = C.axis_group(mesh, ("fsdp",))
        self.shard_replicas = C.axis_group(mesh, ("dcn", "data", "seq"))
        self.token_group = C.axis_group(mesh, TOKEN_AXES)

    def cut(self, params: Any) -> Any:
        """This rank's local shards of a full params tree (a tree that
        mirrors it, e.g. Adam moments, too)."""
        return T.unflatten({p: self.cut_leaf(p, t)
                            for p, t in T.flatten(params).items()})

    def cut_leaf(self, path: str, t: torch.Tensor) -> torch.Tensor:
        """This rank's shard of leaf ``path`` given whole, or of one layer
        of a stacked leaf (``t`` one dim short of the leaf: its leading
        ``layers`` dim, which no rule splits, is dropped from the spec)."""
        spec = self._flat_specs[path]
        if t.dim() == len(spec) - 1:
            spec = spec[1:]
        return cut_local(t, spec, self.sizes, self.coords)

    def state_specs(self, state: dict) -> dict[str, tuple]:
        """Flattened state path → spec: the params' and every optimizer
        tree that mirrors them (``mu``, ``nu``, ``trace``)."""
        out = {}
        for p, s in T.flatten(self.specs).items():
            out[f"params/{p}"] = s
            for tree in ("mu", "nu", "trace"):
                if tree in state.get("opt_state", {}):
                    out[f"opt_state/{tree}/{p}"] = s
        return out

    @torch.no_grad()
    def sync_grads(self, grads: list) -> None:
        """Sum each local gradient over the ranks that hold the same block
        (in place): the gathers' backward already reduce-scattered a
        sharded leaf over ``fsdp``."""
        for g, d in zip(grads, T.leaves(self.dims)):
            C.all_reduce_(g, self.shard_replicas if d is not None
                          else self.token_group)

    def global_norm(self, grads: Any) -> torch.Tensor:
        from kubeflow_tpu_torch.train.optim import global_norm

        return global_norm(grads, dims=self.dims, group=self.fsdp_group)

