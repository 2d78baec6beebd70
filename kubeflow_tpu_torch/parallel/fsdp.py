"""Sharded train state over a mesh (the port's counterpart of the JAX
package's ``_state_shardings`` and GSPMD's FSDP/data-parallel
collectives).

``StateLayout`` holds, for one model's params, each leaf's placement
(``sharding.shard_params``: ``embed`` over ``fsdp``, which for most
leaves is not dim 0; heads, mlp columns and vocab over ``model``) and the
process groups the step needs:

- ``fsdp``: a leaf's gather dim is all-gathered over it where it is used
  (``collectives.GatheredParams``) and its gradient reduce-scattered back;
- ``model``: a leaf's TP dim stays local; the layers' conjugate operators
  (``copy_to_model``, ``reduce_from_model``) make each rank's gradient of
  its block whole, so nothing is summed over ``model`` — except a leaf
  that is whole on every model rank because its dim did not divide
  (GQA's kv heads, ``Placement.partial``), of which each rank reads its
  own part: its gradient is summed over ``model`` too;
- ``expert``: an expert leaf's expert dim stays local (each rank holds
  and updates its own experts); the ranks of one expert group read the
  same batch rows (the batch rule leaves ``expert`` out), and the MoE
  block's conjugate operators over ``expert`` × ``model`` make every
  other gradient whole on each of them, so nothing is summed over
  ``expert``;
- the replica axes: a gathered leaf's gradient is then summed over
  ``dcn``, ``data`` and ``seq`` (the ranks that hold the same shard), a
  leaf with no gather dim over every batch and ``seq`` axis.

The optimizer's moments mirror the params' placements, so Adam runs on
local shards; the global gradient norm sums each block once
(``global_norm``). A ``pipeline`` degree above 1 raises: that axis is
not ported yet.
"""

from __future__ import annotations

from typing import Any

import torch

from kubeflow_tpu_torch.parallel import collectives as C
from kubeflow_tpu_torch.runtime.mesh import batch_sharding_axes
from kubeflow_tpu_torch.parallel.sharding import (
    DEFAULT_RULES, EP_AXIS, TP_AXIS, LogicalRules, ParamLayout, mesh_coords,
    mesh_shape,
)
from kubeflow_tpu_torch.train import tree as T

#: Mesh axes the training step does not split yet.
UNPORTED_AXES = ("pipeline",)
#: The axes a batch is split over, and with ``seq`` every axis a step's
#: loss and replicated gradients are summed over.
BATCH_AXES = batch_sharding_axes()
TOKEN_AXES = BATCH_AXES + ("seq",)


def check_mesh(mesh) -> None:
    """Raise ``NotImplementedError`` for a ``pipeline`` degree above 1."""
    sizes = mesh_shape(mesh)
    big = {a: sizes[a] for a in UNPORTED_AXES if sizes.get(a, 1) > 1}
    if big:
        raise NotImplementedError(
            f"mesh axes {big}: the port trains over the dcn, data, fsdp, "
            "expert, seq and model axes; pipeline parallelism arrives "
            "with ROADMAP.md Queue 1 item 9d")


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


class StateLayout(ParamLayout):
    """Placements and groups of one model's train state on ``mesh``,
    from its logical spec tree and the full (global) params, or tensors
    of their shapes (``meta`` tensors: nothing drawn)."""

    def __init__(self, mesh, logical_specs: Any, params: Any,
                 rules: LogicalRules = DEFAULT_RULES):
        check_mesh(mesh)
        super().__init__(mesh, logical_specs, params, rules)
        #: Each leaf's gather dim (over ``fsdp``), or None.
        self.dims = T.map_tree(lambda p: p.gather, self.placements)
        # Every rank makes the groups here, in one order.
        self.fsdp_group = C.axis_group(mesh, ("fsdp",))
        self.shard_replicas = C.axis_group(mesh, ("dcn", "data", "seq"))
        self.token_group = C.axis_group(mesh, TOKEN_AXES)
        self._partial_groups = (
            C.axis_group(mesh, ("dcn", "data", "seq", TP_AXIS)),
            C.axis_group(mesh, TOKEN_AXES + (TP_AXIS,)))
        self._split_groups = {}
        for p in T.leaves(self.placements):
            axes = self._split_axes(p)
            if axes and axes not in self._split_groups:
                self._split_groups[axes] = C.axis_group(mesh, axes)

    @staticmethod
    def _split_axes(p) -> tuple:
        return tuple(a for a, d in (("fsdp", p.gather), (EP_AXIS, p.ep),
                                    (TP_AXIS, p.tp)) if d is not None)

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
        gathered leaf over ``fsdp``; a ``partial`` leaf's parts are summed
        over ``model`` as well. Nothing is summed over ``expert``: an
        expert leaf's block is its rank's alone, and the ranks of one
        expert group computed every other gradient whole on the same
        rows."""
        for g, p in zip(grads, T.leaves(self.placements)):
            if p.partial:
                group = self._partial_groups[p.gather is None]
            else:
                group = (self.shard_replicas if p.gather is not None
                         else self.token_group)
            C.all_reduce_(g, group)

    def global_norm(self, grads: Any) -> torch.Tensor:
        """The whole gradient's norm: each leaf's squares summed over the
        axes its blocks are split over, a whole leaf's counted once."""
        from kubeflow_tpu_torch.train.optim import global_norm

        groups = T.map_tree(
            lambda p: self._split_groups.get(self._split_axes(p)),
            self.placements)
        return global_norm(grads, groups=groups)
