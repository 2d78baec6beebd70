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
- ``layers``     → replicated (the stacked-layer axis)
"""

from __future__ import annotations

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


def cut_local(full: torch.Tensor, spec: Spec, sizes: dict[str, int],
              coords: dict[str, int]) -> torch.Tensor:
    """The process's local shard of ``full`` (a contiguous copy where it
    is a strict part; ``full`` itself where the leaf is replicated)."""
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


def sharded_dim(spec: Spec, sizes: dict[str, int]) -> Optional[int]:
    """The one dim a leaf is split on (its axes' degree above 1), or None
    for a replicated leaf. Two split dims raise: training gathers one dim
    per leaf, over one axis group."""
    dims = [i for i, e in enumerate(spec) if _degree(e, sizes) > 1]
    if len(dims) > 1:
        raise NotImplementedError(
            f"spec {spec} splits dims {dims}; the port gathers one dim per "
            "leaf (ROADMAP.md Queue 1 item 9)")
    return dims[0] if dims else None


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
