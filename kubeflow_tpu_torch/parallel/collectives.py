"""The collectives of sharded training, over a ``DeviceMesh``'s process
groups: groups over combinations of mesh axes, autograd-aware
all-gather (reduce-scatter backward), ring rotation and all-to-all, and
Megatron's conjugate operators (``copy_to`` and ``reduce_from`` over any
group: the ``model`` axis's ``copy_to_model``, ``reduce_from_model``,
and the MoE block's ``expert`` × ``model`` ranks; ``gather_from_model``),
and the pipeline axis's point-to-point exchange between neighbouring
stages (``pipeline_axis``, ``exchange``).

Each process holds local tensors; these functions are where shards meet.
Every rank must make the same calls in the same order, as with any
collective. Only calls present in torch 2.11 and later are used.
"""

from __future__ import annotations

import dataclasses
import math
import warnings
from collections.abc import Mapping
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from kubeflow_tpu_torch.parallel.sharding import all_coords, mesh_shape

# torch 2.13 renames the tensor forms of all-gather and reduce-scatter
# (*_single) and warns on the old names, which torch 2.11 has alone.
warnings.filterwarnings(
    "ignore", message=r".*is deprecated\. Please use `torch\.distributed\.",
    category=FutureWarning)


def axis_group(mesh, axes: Sequence[str]):
    """The process group of the ranks that share this rank's coordinates on
    every axis but ``axes``; None when ``axes`` hold one rank. A single
    axis is the mesh's own group; a combination is made on first use by
    every rank (``dist.new_group`` over each combination, in one order)
    and kept on the mesh. The combination spanning every axis of degree
    above 1 is the world."""
    if mesh is None:
        return None
    sizes = mesh_shape(mesh)
    live = tuple(a for a in mesh.mesh_dim_names
                 if a in axes and sizes[a] > 1)
    if not live:
        return None
    if len(live) == 1:
        return mesh.get_group(live[0])
    if math.prod(sizes[a] for a in live) == mesh.size():
        return dist.group.WORLD
    cache = mesh.__dict__.setdefault("_kftpu_groups", {})
    if live not in cache:
        others = [a for a in mesh.mesh_dim_names if a not in live]
        me = dist.get_rank()
        mine = None
        for oc in all_coords(sizes, others):
            ranks = []
            for lc in all_coords(sizes, live):
                c = {**oc, **lc}
                ranks.append(int(mesh.mesh[tuple(
                    c[a] for a in mesh.mesh_dim_names)]))
            g = dist.new_group(ranks)
            if me in ranks:
                mine = g
        cache[live] = mine
    return cache[live]


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """Sum ``t`` over ``group`` in place (nothing without a group)."""
    if group is not None:
        dist.all_reduce(t, group=group)
    return t


class _AllGather(torch.autograd.Function):
    """All-gather along ``dim`` over ``group``; the backward
    reduce-scatters (sums) the gradient back to each rank's part."""

    @staticmethod
    def forward(ctx, x, dim: int, group):
        ctx.dim, ctx.group = dim, group
        n = dist.get_world_size(group)
        xt = x.movedim(dim, 0).contiguous()
        out = xt.new_empty((n * xt.shape[0], *xt.shape[1:]))
        dist.all_gather_into_tensor(out, xt, group=group)
        return out.movedim(0, dim)

    @staticmethod
    def backward(ctx, g):
        gt = g.movedim(ctx.dim, 0).contiguous()
        n = dist.get_world_size(ctx.group)
        out = gt.new_empty((gt.shape[0] // n, *gt.shape[1:]))
        dist.reduce_scatter_tensor(out, gt, group=ctx.group)
        return out.movedim(0, ctx.dim), None, None


def gather_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """``x``'s parts over ``group`` concatenated along ``dim``, in group
    rank order; differentiable (reduce-scatter backward). ``x`` itself
    without a group."""
    if group is None or dist.get_world_size(group) == 1:
        return x
    return _AllGather.apply(x, dim, group)


def ring_shift(tensors: Sequence[torch.Tensor], group,
               shift: int = 1) -> list[torch.Tensor]:
    """Each tensor sent to the rank ``shift`` places on around ``group``
    and replaced by the one from ``shift`` places back, in one batch of
    point-to-point operations (peers are global ranks)."""
    n = dist.get_world_size(group)
    me = dist.get_rank(group)
    dst = dist.get_global_rank(group, (me + shift) % n)
    src = dist.get_global_rank(group, (me - shift) % n)
    outs = [torch.empty_like(t) for t in tensors]
    ops = []
    for i, (t, o) in enumerate(zip(tensors, outs)):
        ops.append(dist.P2POp(dist.isend, t.contiguous(), dst, group, tag=i))
        ops.append(dist.P2POp(dist.irecv, o, src, group, tag=i))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return outs


class _Rotate(torch.autograd.Function):
    """``ring_shift`` by one as an autograd op: the backward sends the
    gradients the other way round."""

    @staticmethod
    def forward(ctx, group, *xs):
        ctx.group = group
        return tuple(ring_shift(xs, group, 1))

    @staticmethod
    def backward(ctx, *gs):
        return (None, *ring_shift(gs, ctx.group, -1))


def rotate(group, *xs: torch.Tensor) -> tuple[torch.Tensor, ...]:
    return _Rotate.apply(group, *xs)


def _a2a(x: torch.Tensor, group, split_dim: int,
         concat_dim: int) -> torch.Tensor:
    n = dist.get_world_size(group)
    send = torch.stack(x.chunk(n, dim=split_dim)).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return torch.cat(recv.unbind(0), dim=concat_dim)


class _AllToAll(torch.autograd.Function):
    """Split ``split_dim`` into group-size parts, send part j to rank j,
    and concatenate the parts received along ``concat_dim`` in rank order;
    the backward is the inverse all-to-all."""

    @staticmethod
    def forward(ctx, x, group, split_dim: int, concat_dim: int):
        ctx.args = (group, split_dim, concat_dim)
        return _a2a(x, group, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        group, split_dim, concat_dim = ctx.args
        return _a2a(g, group, concat_dim, split_dim), None, None, None


def all_to_all(x: torch.Tensor, group, split_dim: int,
               concat_dim: int) -> torch.Tensor:
    return _AllToAll.apply(x, group, split_dim, concat_dim)


def seq_info(mesh) -> tuple[Optional[object], int, int]:
    """(group, index, size) of this rank on the mesh's ``seq`` axis; (None,
    0, 1) without a mesh or sequence parallelism."""
    if mesh is None or mesh_shape(mesh).get("seq", 1) == 1:
        return None, 0, 1
    return (mesh.get_group("seq"), mesh.get_local_rank("seq"),
            mesh_shape(mesh)["seq"])


class GatheredParams(Mapping):
    """A params tree of local shards read as whole tensors: indexing a
    leaf all-gathers it along its sharded dim over ``group`` (at each
    access, so a remat replay gathers again and no gathered copy outlives
    its use); ``layer(i)`` views layer ``i`` of the stacked ``[L, ...]``
    leaves, so a layer is gathered only where it runs. ``dims`` mirrors
    the tree: each leaf's sharded dim, or None for a replicated leaf
    (returned as it is)."""

    def __init__(self, tree: dict, dims: dict, group,
                 layer: Optional[int] = None):
        self._tree, self._dims, self._group, self._layer = (
            tree, dims, group, layer)

    def __getitem__(self, key):
        v, d = self._tree[key], self._dims[key]
        if isinstance(v, dict):
            return GatheredParams(v, d, self._group, self._layer)
        if self._layer is not None:
            v = v[self._layer]
            d = None if d is None else d - 1
        return v if d is None else gather_dim(v, d, self._group)

    def __iter__(self):
        return iter(self._tree)

    def __len__(self) -> int:
        return len(self._tree)

    def layer(self, i: int) -> "GatheredParams":
        return GatheredParams(self._tree, self._dims, self._group, i)


# -- the model axis (tensor parallelism) ---------------------------------------

@dataclasses.dataclass(frozen=True)
class ModelAxis:
    """This process's place on the ``model`` mesh axis: the group of the
    ranks that hold the other shards of the same layers, its index there
    and their number."""

    group: object
    rank: int
    size: int


def part(whole: int, rank: int, size: int) -> tuple[int, int]:
    """``[start, stop)`` of rank ``rank``'s part of ``whole`` over ``size``
    ranks: the even split where it divides, balanced parts otherwise."""
    return rank * whole // size, (rank + 1) * whole // size


def axis_part(whole: int, tp: Optional[ModelAxis]) -> tuple[int, int]:
    """This rank's ``part`` of ``whole`` over the model axis ``tp``; all of
    it without one."""
    return (0, whole) if tp is None else part(whole, tp.rank, tp.size)


def model_axis(mesh) -> Optional[ModelAxis]:
    """The ``model`` axis of ``mesh``; None without a mesh or with
    ``model == 1``."""
    if mesh is None or mesh_shape(mesh).get("model", 1) == 1:
        return None
    return ModelAxis(mesh.get_group("model"), mesh.get_local_rank("model"),
                     mesh_shape(mesh)["model"])


class _CopyToModel(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over the axis."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromModel(torch.autograd.Function):
    """Sum over the axis forward; identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    """All-gather along the last dim forward (each rank's block padded to
    the widest of ``widths``, the padding dropped); the backward keeps
    this rank's columns."""

    @staticmethod
    def forward(ctx, x, group, rank: int, widths: tuple):
        lo = sum(widths[:rank])
        ctx.cols = (lo, lo + widths[rank])
        n, wide = len(widths), max(widths)
        xt = x.movedim(-1, 0)
        if xt.shape[0] < wide:
            xt = torch.cat([xt, xt.new_zeros((wide - xt.shape[0],
                                              *xt.shape[1:]))])
        xt = xt.contiguous()
        out = xt.new_empty((n * wide, *xt.shape[1:]))
        dist.all_gather_into_tensor(out, xt, group=group)
        if any(w != wide for w in widths):
            out = torch.cat([out[r * wide:r * wide + w]
                             for r, w in enumerate(widths)])
        return out.movedim(0, -1)

    @staticmethod
    def backward(ctx, g):
        lo, hi = ctx.cols
        return g[..., lo:hi], None, None, None


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    """The input of a product whose ranks over ``group`` each compute a
    part: ``x`` as it is, whose gradient the backward sums over the
    ranks' partial ones (nothing without a group)."""
    if group is None or not (torch.is_grad_enabled() and x.requires_grad):
        return x
    return _CopyToModel.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    """The ranks' partial sums over ``group`` added up (every rank gets
    the total); the backward is the identity. Without a gradient to
    record it is summed in place: the callers pass a fresh product."""
    if group is None:
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _ReduceFromModel.apply(x, group)
    x = x.contiguous()
    dist.all_reduce(x, group=group)
    return x


def copy_to_model(x: torch.Tensor, tp: Optional[ModelAxis]) -> torch.Tensor:
    """The input of a column-parallel product (``copy_to`` over the
    model axis)."""
    return copy_to(x, None if tp is None else tp.group)


def reduce_from_model(x: torch.Tensor,
                      tp: Optional[ModelAxis]) -> torch.Tensor:
    """The output of a row-parallel product (``reduce_from`` over the
    model axis)."""
    return reduce_from(x, None if tp is None else tp.group)


def gather_from_model(x: torch.Tensor, tp: Optional[ModelAxis],
                      whole: Optional[int] = None) -> torch.Tensor:
    """The ranks' column blocks of the last dim, concatenated in rank order
    (the serving logits over the whole vocabulary): equal blocks, or with
    ``whole`` the balanced parts of ``whole`` columns (``part``)."""
    if tp is None:
        return x
    n = tp.size
    widths = tuple(b - a for a, b in (part(whole, r, n) for r in range(n))) \
        if whole else (x.shape[-1],) * n
    return _GatherFromModel.apply(x, tp.group, tp.rank, widths)


# -- the pipeline axis ---------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PipelineAxis:
    """This process's place on the ``pipeline`` mesh axis: the group of
    the ranks that differ from it only there, its stage, the number of
    stages, and each stage's global rank (from the mesh's coordinates)."""

    group: object
    stage: int
    size: int
    ranks: tuple


def pipeline_axis(mesh) -> Optional[PipelineAxis]:
    """The ``pipeline`` axis of ``mesh``; None without a mesh or with
    ``pipeline == 1``. The group's first use is a collective over every
    stage, which a batch of point-to-point calls over NCCL needs."""
    from kubeflow_tpu_torch.runtime.mesh import pipeline_ranks

    if mesh is None or mesh_shape(mesh).get("pipeline", 1) == 1:
        return None
    group = mesh.get_group("pipeline")
    if not mesh.__dict__.get("_kftpu_pipeline_ready"):
        dev = "cuda" if mesh.device_type == "cuda" else "cpu"
        dist.all_reduce(torch.zeros(1, device=dev), group=group)
        mesh.__dict__["_kftpu_pipeline_ready"] = True
    return PipelineAxis(group, mesh.get_local_rank("pipeline"),
                        mesh_shape(mesh)["pipeline"],
                        tuple(pipeline_ranks(mesh)))


#: Tag offset of the cotangents (which flow toward the first stage) over
#: the activations' tags 0, 1, ...
_COTANGENT_TAG = 64


def exchange(axis: PipelineAxis, send: Optional[str], tensors, recv:
             Optional[str], template, device) -> Optional[list]:
    """One exchange of a stage's schedule: ``tensors`` to the ``send``
    neighbour ("next" stage or "prev") and a receive of ``template``'s
    shapes and dtypes from the ``recv`` neighbour, in one batch of
    point-to-point calls (a send and a receive of the same tick cannot
    wait on each other). Activations travel toward the next stage,
    cotangents toward the previous one; each tensor has its own tag."""
    ops, outs = [], None

    def peer(side: str) -> int:
        return axis.ranks[axis.stage + (1 if side == "next" else -1)]

    if send is not None:
        base = 0 if send == "next" else _COTANGENT_TAG
        for j, t in enumerate(tensors):
            ops.append(dist.P2POp(dist.isend, t.contiguous(), peer(send),
                                  axis.group, tag=base + j))
    if recv is not None:
        base = 0 if recv == "prev" else _COTANGENT_TAG
        outs = [torch.empty(shape, dtype=dt, device=device)
                for shape, dt in template]
        for j, o in enumerate(outs):
            ops.append(dist.P2POp(dist.irecv, o, peer(recv), axis.group,
                                  tag=base + j))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return outs
