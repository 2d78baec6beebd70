"""Device mesh construction from a ParallelismSpec (port of
``kubeflow_tpu/runtime/mesh.py``).

One canonical axis order, outermost → innermost by physical distance:

    dcn       — between hosts (data parallel)
    pipeline  — stages
    data      — replicated data parallel (gradient all-reduce)
    fsdp      — sharded data parallel (all-gather/reduce-scatter of params)
    expert    — MoE expert parallel (each rank its experts; one
                all-reduce of the combined partials over expert × model,
                as JAX's code does: the batch is not split over expert, so
                there is no all-to-all)
    seq       — sequence/context parallel (ring attention K/V rotation)
    model     — tensor parallel (innermost)

All seven axes always exist on the mesh: a size-1 axis costs nothing and
keeps the sharding rules uniform. The mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the process group the
worker joined (one process per device), ranks laid out row-major.
"""

from __future__ import annotations

import math

from kubeflow_tpu_torch.core.jobs import ParallelismSpec

MESH_AXES: tuple[str, ...] = (
    "dcn", "pipeline", "data", "fsdp", "expert", "seq", "model",
)


def mesh_sizes(axis_sizes: dict[str, int]) -> tuple[int, ...]:
    """The seven degrees in ``MESH_AXES`` order; an unknown axis raises."""
    unknown = sorted(set(axis_sizes) - set(MESH_AXES))
    if unknown:
        raise ValueError(f"unknown mesh axes {unknown}; known: {MESH_AXES}")
    return tuple(int(axis_sizes.get(a, 1)) for a in MESH_AXES)


def build_mesh(axis_sizes: dict[str, int], device_type: str = "cpu"):
    """The canonical 7-axis mesh over the default process group.

    ``axis_sizes`` maps axis name → degree; missing axes default to 1. The
    product must equal the world size (JAX's ``ValueError`` otherwise).
    ``device_type`` is "cuda" on the card, "cpu" for gloo workers."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    sizes = mesh_sizes(axis_sizes)
    n = math.prod(sizes)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n != world:
        raise ValueError(
            f"mesh axes {dict(zip(MESH_AXES, sizes))} product {n} "
            f"!= device count {world}")
    return init_device_mesh(device_type, sizes, mesh_dim_names=MESH_AXES)


def mesh_from_parallelism(spec: ParallelismSpec, device_type: str = "cpu"):
    return build_mesh(spec.axis_sizes(), device_type)


def infer_parallelism(num_devices: int, *,
                      prefer: str = "fsdp") -> ParallelismSpec:
    """Default policy when a job doesn't pin axes: everything on one axis
    (fsdp by default)."""
    return ParallelismSpec(**{prefer: num_devices})


def pipeline_ranks(mesh) -> list[int]:
    """The global ranks of this process's pipeline group, by stage: the
    ranks whose mesh coordinates equal this process's on every axis but
    ``pipeline`` (read off the mesh, whatever the axis order)."""
    names = list(mesh.mesh_dim_names)
    coords = [mesh.get_local_rank(a) for a in names]
    at = names.index("pipeline")
    out = []
    for s in range(mesh.mesh.shape[at]):
        coords[at] = s
        out.append(int(mesh.mesh[tuple(coords)]))
    return out


def batch_sharding_axes() -> tuple[str, ...]:
    """Mesh axes the global batch dimension is sharded over (pipeline is
    not one of them: microbatches flow through stages instead)."""
    return ("dcn", "data", "fsdp")
