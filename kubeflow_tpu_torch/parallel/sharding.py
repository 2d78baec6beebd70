"""Logical-axis sharding rules (port of
``kubeflow_tpu/parallel/sharding.py``).

Models annotate every parameter with *logical* axis names; a rule table
maps logical names → mesh axes (or None = replicated). The JAX package
hands the resulting ``PartitionSpec``s to GSPMD; here they are explicit:
a spec is a tuple with one entry per dim (None, a mesh axis, or a tuple
of mesh axes), and each process holds its *local shard* of every leaf,
the block its mesh coordinates pick (``local_slices``, ``cut_local``),
which ``assemble`` puts back together.

Default rule intent:
- ``batch``      → sharded over all data-parallel axes (dcn, data, fsdp)
- ``embed``      → FSDP-sharded (params' model dim over fsdp; ZeRO-3)
- ``heads/mlp/kv/vocab`` → tensor-parallel over ``model``
- ``expert``     → expert-parallel over ``expert``
- ``act_seq``    → sequence-parallel over ``seq`` (ring attention)
- ``layers``     → replicated (the stacked-layer axis); a pipeline-parallel
  train state maps it to ``pipeline`` (``with_rule``), so stage s holds
  layers [s·L/n, (s+1)·L/n) and every other leaf is whole on each stage
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Any, Optional, Sequence, Union

import torch

Axis = Optional[Union[str, tuple[str, ...]]]
LogicalRules = tuple[tuple[str, Axis], ...]
#: A leaf's placement: one entry per dim (the port's ``PartitionSpec``).
Spec = tuple

DEFAULT_RULES: LogicalRules = (
    ("batch", ("dcn", "data", "fsdp")),
    ("act_seq", "seq"),
    ("act_embed", None),
    ("embed", "fsdp"),
    ("heads", "model"),
    ("kv_heads", "model"),
    ("head_dim", None),
    ("mlp", "model"),
    ("vocab", "model"),
    # The embedding table stores vocab-parallel over ``model`` and
    # ZeRO-3-sharded over ``fsdp`` on the hidden dim; the forward gathers
    # the hidden dim before the token lookup.
    ("embed_table", "fsdp"),
    ("expert", "expert"),
    ("expert_mlp", "model"),
    ("layers", None),
    ("stage", "pipeline"),
    ("norm", None),
)


def with_rule(rules: LogicalRules, name: str, axis: Axis) -> LogicalRules:
    """A copy of ``rules`` with one mapping replaced."""
    return tuple((n, axis if n == name else a) for n, a in rules)


def logical_to_mesh_axes(
    logical_axes: Sequence[Optional[str]],
    rules: LogicalRules = DEFAULT_RULES,
) -> Spec:
    """Map a tuple of logical axis names to a spec via the rules.

    A mesh axis may be used at most once in a spec: later logical axes
    that would reuse an already-consumed mesh axis fall back to
    replication on that axis."""
    table = dict(rules)
    used: set[str] = set()
    out: list = []
    for name in logical_axes:
        if name is None:
            out.append(None)
            continue
        if name not in table:
            raise KeyError(f"no sharding rule for logical axis {name!r}")
        mesh_axes = table[name]
        if mesh_axes is None:
            out.append(None)
            continue
        if isinstance(mesh_axes, str):
            mesh_axes = (mesh_axes,)
        free = tuple(a for a in mesh_axes if a not in used)
        used.update(free)
        if not free:
            out.append(None)
        elif len(free) == 1:
            out.append(free[0])
        else:
            out.append(free)
    return tuple(out)


def _is_spec_leaf(x: Any) -> bool:
    return isinstance(x, tuple) and all(
        isinstance(e, (str, type(None))) for e in x)


def mesh_shape(mesh) -> dict[str, int]:
    """Axis name → degree of a ``DeviceMesh``, or of a dict of degrees
    (missing axes are 1)."""
    if isinstance(mesh, dict):
        return mesh
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def mesh_coords(mesh) -> dict[str, int]:
    """This process's coordinate on every axis of a ``DeviceMesh``."""
    return {a: mesh.get_local_rank(a) for a in mesh.mesh_dim_names}


def _axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _degree(entry, sizes: dict[str, int]) -> int:
    return math.prod(int(sizes.get(a, 1)) for a in _axes(entry))


def _drop_nondivisible(spec: Spec, shape: tuple[int, ...], mesh) -> Spec:
    """Replicate any dim whose size isn't divisible by its mesh-axis
    product (e.g. 2 GQA kv heads under model=4)."""
    sizes = mesh_shape(mesh)
    out = []
    for dim, axes in zip(shape, tuple(spec) + (None,) * (len(shape)
                                                          - len(spec))):
        if axes is None:
            out.append(None)
            continue
        degree = _degree(axes, sizes)
        out.append(axes if degree > 0 and dim % degree == 0 else None)
    return tuple(out)


def _map_specs(fn, specs: Any, *rest: Any) -> Any:
    """``fn(spec, *leaves)`` over a spec tree (dicts and lists of spec
    tuples) and trees of the same structure."""
    if _is_spec_leaf(specs):
        return fn(specs, *rest)
    if isinstance(specs, dict):
        return {k: _map_specs(fn, v, *(r[k] for r in rest))
                for k, v in specs.items()}
    if isinstance(specs, (list, tuple)):
        return type(specs)(_map_specs(fn, v, *(r[i] for r in rest))
                           for i, v in enumerate(specs))
    raise TypeError(f"not a spec tree node: {specs!r}")


def shard_params(params: Any, specs: Any, mesh,
                 rules: LogicalRules = DEFAULT_RULES) -> Any:
    """Each leaf's placement (a spec tuple) on ``mesh``, from the parallel
    ``specs`` tree of logical-axis tuples. ``params`` may be tensors,
    anything with a ``shape``, or None (then no dim is dropped); a dim that
    does not divide its mesh-axis product is replicated, as JAX's
    ``shard_params`` does."""
    if params is None:
        return _map_specs(lambda s: logical_to_mesh_axes(s, rules), specs)
    return _map_specs(
        lambda s, leaf: _drop_nondivisible(
            logical_to_mesh_axes(s, rules), tuple(leaf.shape), mesh),
        specs, params)


def local_slices(shape: Sequence[int], spec: Spec, sizes: dict[str, int],
                 coords: dict[str, int]) -> tuple[slice, ...]:
    """The block of a leaf of global ``shape`` that the process at
    ``coords`` holds: each sharded dim is cut into ``degree`` equal parts,
    the part's index the process's coordinates over that dim's axes,
    row-major (the first axis outermost)."""
    out = []
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    for dim, entry in zip(shape, spec):
        axes = _axes(entry)
        degree = _degree(entry, sizes)
        if degree == 1:
            out.append(slice(0, dim))
            continue
        if dim % degree:
            raise ValueError(f"dim {dim} does not divide over {axes} "
                             f"(degree {degree})")
        idx = 0
        for a in axes:
            idx = idx * int(sizes.get(a, 1)) + int(coords.get(a, 0))
        part = dim // degree
        out.append(slice(idx * part, (idx + 1) * part))
    return tuple(out)


def cut_local(full, spec: Spec, sizes: dict[str, int],
              coords: dict[str, int]):
    """The process's local shard of ``full`` (a contiguous copy where it
    is a strict part; ``full`` itself where the leaf is replicated). An
    int8 ``QuantizedTensor`` is cut per field, as JAX's ``shard_params``
    does: the payload by ``spec``, the scale likewise except on its
    collapsed contraction dims (size 1), which are never split, so each
    shard keeps the whole weight's per-channel scales."""
    if hasattr(full, "scale"):
        sspec = tuple(None if n == 1 and q > 1 else e for e, n, q in zip(
            tuple(spec) + (None,) * len(full.shape), full.scale.shape,
            full.shape))
        return type(full)(cut_local(full.q, spec, sizes, coords),
                          cut_local(full.scale, sspec, sizes, coords))
    sl = local_slices(full.shape, spec, sizes, coords)
    if all(s.start == 0 and s.stop == d for s, d in zip(sl, full.shape)):
        return full
    return full[sl].contiguous()


def all_coords(sizes: dict[str, int],
               axes: Sequence[str]) -> list[dict[str, int]]:
    """Every coordinate over ``axes``, row-major."""
    return [dict(zip(axes, c)) for c in itertools.product(
        *(range(int(sizes.get(a, 1))) for a in axes))]


def assemble(shape: Sequence[int], spec: Spec, sizes: dict[str, int],
             shard_of) -> torch.Tensor:
    """The inverse of ``cut_local``: the full leaf from ``shard_of(coords)``
    over every coordinate of the axes ``spec`` shards on."""
    axes = sorted({a for e in spec for a in _axes(e)})
    blocks = all_coords(sizes, axes)
    first = shard_of(blocks[0])
    out = torch.empty(tuple(shape), dtype=first.dtype, device=first.device)
    for c in blocks:
        out[local_slices(shape, spec, sizes, c)] = shard_of(c)
    return out


#: The mesh axis whose shards stay local: a leaf's dim split over it is
#: never gathered (Megatron tensor parallelism, ``models/layers.py``).
TP_AXIS = "model"
#: Likewise the expert axis: a rank computes its own experts, and the MoE
#: block sums the combined partials over ``expert`` × ``model``.
EP_AXIS = "expert"
#: And the pipeline axis: a stage holds and updates its own layers.
PP_AXIS = "pipeline"
LOCAL_AXES = (TP_AXIS, EP_AXIS, PP_AXIS)


@dataclasses.dataclass(frozen=True)
class Placement:
    """Where a leaf is split: ``gather``, its dim over the other axes
    (``fsdp``), all-gathered where the leaf is used; ``tp``, its dim over
    ``model``, ``ep``, its dim over ``expert``, and ``stage``, its stacked
    layer dim over ``pipeline``, which stay local.
    ``partial``: the logical spec splits a dim over ``model`` but it did
    not divide, so the leaf is whole on every model rank (as JAX
    replicates it) and each computes with its own part of it (the kv heads
    of GQA, heads, mlp columns, the vocabulary; ``collectives.part``): its
    gradient is then summed over ``model``. ``ep_partial``: likewise for
    experts that do not divide over ``expert``. None for a dim not
    split."""

    gather: Optional[int] = None
    tp: Optional[int] = None
    partial: bool = False
    ep: Optional[int] = None
    stage: Optional[int] = None
    ep_partial: bool = False


def placement(spec: Spec, sizes: dict[str, int],
              wanted: Optional[Spec] = None) -> Placement:
    """The ``Placement`` of a leaf of ``spec`` on a mesh of ``sizes``;
    ``wanted`` is its spec before ``_drop_nondivisible`` (``partial`` when
    it names ``model`` and ``spec`` does not, ``ep_partial`` likewise for
    ``expert``). A dim split over ``model`` or ``expert`` and another axis
    at once, or two dims over the other axes, raise: a leaf gathers one
    dim, over one group."""
    gather, tp, ep, stage = [], [], [], []
    for i, e in enumerate(spec):
        axes = [a for a in _axes(e) if int(sizes.get(a, 1)) > 1]
        local = [a for a in axes if a in LOCAL_AXES]
        if local and len(axes) > 1:
            raise NotImplementedError(
                f"spec {spec}: dim {i} splits over {axes}; a dim is split "
                f"over {local[0]!r} alone (ROADMAP.md Queue 1)")
        if axes:
            {TP_AXIS: tp, EP_AXIS: ep, PP_AXIS: stage}.get(
                axes[0], gather).append(i)
    if len(gather) > 1:
        raise NotImplementedError(
            f"spec {spec} splits dims {gather} outside {LOCAL_AXES}; a leaf "
            "gathers one dim (ROADMAP.md Queue 1)")

    def dropped(axis: str) -> bool:
        def on(s) -> bool:
            return any(axis in _axes(e) for e in s or ())

        return int(sizes.get(axis, 1)) > 1 and on(wanted) and not on(spec)

    return Placement(gather[0] if gather else None, tp[0] if tp else None,
                     dropped(TP_AXIS), ep[0] if ep else None,
                     stage[0] if stage else None, dropped(EP_AXIS))


class ParamLayout:
    """One model's params laid out on ``mesh``: each leaf's spec
    (``shard_params`` of the logical ``specs`` tree over ``params``, the
    full tree or tensors of its shapes), its ``Placement``, and this
    process's cut of a leaf. It makes no process group: a train state's
    ``fsdp.StateLayout`` adds the groups its step needs, while a sharded
    init, a tensor-parallel engine and a checkpoint read need only the
    cut."""

    def __init__(self, mesh, logical_specs: Any, params: Any,
                 rules: LogicalRules = DEFAULT_RULES):
        from kubeflow_tpu_torch.train import tree as T

        self.mesh = mesh
        self.sizes = mesh_shape(mesh)
        self.coords = mesh_coords(mesh)
        self.specs = shard_params(params, logical_specs, mesh, rules)
        #: Flattened leaf path → spec.
        self.flat_specs = T.flatten(self.specs)
        wanted = T.flatten(shard_params(None, logical_specs, mesh, rules))
        self.placements = T.unflatten({
            p: placement(s, self.sizes, wanted[p])
            for p, s in self.flat_specs.items()})

    def cut_leaf(self, path: str, t):
        """This process's shard of leaf ``path`` given whole, or of one
        layer of a stacked leaf (``t`` one dim short of the leaf: its
        leading ``layers`` dim is dropped from the spec; under
        ``pipeline`` the caller keeps only ``stage_layers``' layers)."""
        spec = self.flat_specs[path]
        if len(t.shape) == len(spec) - 1:
            spec = spec[1:]
        return cut_local(t, spec, self.sizes, self.coords)

    def stage_layers(self, n_layers: int) -> range:
        """The global indices of the stacked layers this process holds:
        its stage's block under a ``pipeline`` degree, every layer
        otherwise."""
        n = int(self.sizes.get(PP_AXIS, 1))
        if n == 1:
            return range(n_layers)
        per = n_layers // n
        s = int(self.coords.get(PP_AXIS, 0))
        return range(s * per, (s + 1) * per)

    def cut(self, params: Any) -> Any:
        """This process's shards of a full params tree (or of a tree that
        mirrors it, e.g. Adam moments)."""
        from kubeflow_tpu_torch.train import tree as T

        return T.unflatten({p: self.cut_leaf(p, t)
                            for p, t in T.flatten(params).items()})


def with_logical_constraint(
    x: torch.Tensor,
    logical_axes: Sequence[Optional[str]],
    mesh=None,
    rules: LogicalRules = DEFAULT_RULES,
) -> torch.Tensor:
    """JAX's ``with_sharding_constraint`` in logical-axis terms. A port
    tensor is already its process's local block, so the constraint has
    nothing to move: the names are resolved (an unknown one raises, as in
    JAX) and ``x`` is returned, with a mesh or without one."""
    logical_to_mesh_axes(logical_axes, rules)
    return x
