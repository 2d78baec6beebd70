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
  (kv or q heads, mlp columns, the vocabulary: ``Placement.partial``),
  of which each rank computes with its own part: its gradient is summed
  over ``model`` too;
- ``expert``: an expert leaf's expert dim stays local (each rank holds
  and updates its own experts); the ranks of one expert group read the
  same batch rows (the batch rule leaves ``expert`` out), and the MoE
  block's conjugate operators over ``expert`` × ``model`` make every
  other gradient whole on each of them, so nothing is summed over
  ``expert`` — except experts that did not divide (whole on every rank,
  each computing its part of them, ``Placement.ep_partial``);
- ``pipeline``: a layer leaf's stacked dim stays local (each stage holds
  and updates its layers, ``parallel/pipeline.py``); the other leaves
  (``embed``, ``final_norm``, ``lm_head``) are whole on every stage and
  used by the first or the last, so their gradients are summed over
  ``pipeline`` too (zeros where a stage does not use them; a tied
  embedding's two parts add up);
- the replica axes: a gathered leaf's gradient is then summed over
  ``dcn``, ``data`` and ``seq`` (the ranks that hold the same shard), a
  leaf with no gather dim over every batch and ``seq`` axis.

The optimizer's moments mirror the params' placements, so Adam runs on
local shards; the global gradient norm sums each block once
(``global_norm``): a leaf split over stages sums its squares over
``pipeline``, a leaf whole on every stage counts once.
"""

from __future__ import annotations

from typing import Any

import torch

from kubeflow_tpu_torch.parallel import collectives as C
from kubeflow_tpu_torch.runtime.mesh import batch_sharding_axes
from kubeflow_tpu_torch.parallel.sharding import (
    DEFAULT_RULES, EP_AXIS, PP_AXIS, TP_AXIS, LogicalRules, ParamLayout,
    mesh_coords, mesh_shape,
)
from kubeflow_tpu_torch.train import tree as T

#: The axes a batch is split over, and with ``seq`` every axis a step's
#: loss and replicated gradients are summed over.
BATCH_AXES = batch_sharding_axes()
TOKEN_AXES = BATCH_AXES + ("seq",)


def check_mesh(mesh) -> None:
    """Raise ``ValueError`` for a mesh with an axis the training step does
    not know (every axis of ``runtime/mesh.MESH_AXES`` trains)."""
    from kubeflow_tpu_torch.runtime.mesh import mesh_sizes

    mesh_sizes(mesh_shape(mesh))


def pipelined(mesh) -> bool:
    """Whether ``mesh`` stages the layers (a ``pipeline`` degree above
    1)."""
    return mesh is not None and mesh_shape(mesh).get(PP_AXIS, 1) > 1


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
        self.token_group = C.axis_group(mesh, TOKEN_AXES)
        # Each leaf's gradient group (the ranks holding the same block,
        # which computed parts of its gradient), made by every rank in
        # leaf order.
        self._sum_groups = {}
        self._split_groups = {}
        for p in T.leaves(self.placements):
            for axes, groups in ((self._sum_axes(p), self._sum_groups),
                                 (self._split_axes(p), self._split_groups)):
                if axes and axes not in groups:
                    groups[axes] = C.axis_group(mesh, axes)

    @staticmethod
    def _split_axes(p) -> tuple:
        return tuple(a for a, d in (("fsdp", p.gather), (EP_AXIS, p.ep),
                                    (TP_AXIS, p.tp), (PP_AXIS, p.stage))
                     if d is not None)

    @staticmethod
    def _sum_axes(p) -> tuple:
        """The axes a leaf's gradient is summed over: the batch and
        ``seq`` axes (``fsdp`` left out where its gathers reduce-scatter),
        ``model`` for a ``partial`` leaf, ``expert`` for an ``ep_partial``
        one, ``pipeline`` for a leaf whole on every stage."""
        axes = ("dcn", "data", "seq") if p.gather is not None else TOKEN_AXES
        if p.partial:
            axes += (TP_AXIS,)
        if p.ep_partial:
            axes += (EP_AXIS,)
        if p.stage is None:
            axes += (PP_AXIS,)
        return axes

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
        over ``model`` as well, an ``ep_partial`` one's over ``expert``, a
        leaf whole on every stage over ``pipeline``. Nothing else is
        summed over ``expert``: an expert leaf's block is its rank's
        alone, and the ranks of one expert group computed every other
        gradient whole on the same rows."""
        for g, p in zip(grads, T.leaves(self.placements)):
            C.all_reduce_(g, self._sum_groups.get(self._sum_axes(p)))

    def global_norm(self, grads: Any) -> torch.Tensor:
        """The whole gradient's norm: each leaf's squares summed over the
        axes its blocks are split over, a whole leaf's counted once."""
        from kubeflow_tpu_torch.train.optim import global_norm

        groups = T.map_tree(
            lambda p: self._split_groups.get(self._split_axes(p)),
            self.placements)
        return global_norm(grads, groups=groups)
