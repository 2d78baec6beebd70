"""The parallelism half of a job spec (port of ``ParallelismSpec`` in
``kubeflow_tpu/core/jobs.py``): the mesh-axis degrees a worker's data
plane is laid out over. A dataclass with the JAX model's fields, checks
(integer fields, no unknown keys) and ``axis_sizes()``."""

from __future__ import annotations

import dataclasses
from typing import Any


@dataclasses.dataclass(frozen=True)
class ParallelismSpec:
    """Mesh-axis degrees for the SPMD data plane.

    Axis order (outer→inner) mirrors physical distance: between hosts
    (``dcn``), then pipeline, data/fsdp, expert/seq, and ``model``
    innermost (its collectives are latency-bound, so nearest neighbours)."""

    dcn: int = 1        # data parallel across hosts
    pipeline: int = 1   # pipeline stages
    data: int = 1       # pure data parallel (replicated params)
    fsdp: int = 1       # sharded data parallel (params sharded)
    expert: int = 1     # MoE expert parallel
    seq: int = 1        # sequence/context parallel (ring attention)
    model: int = 1      # tensor parallel

    def __post_init__(self):
        # pydantic's lax int: an int, an integral float or an integer
        # string is taken; anything else (a bool too) is refused.
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, int) and not isinstance(v, bool):
                continue
            if isinstance(v, float) and v.is_integer():
                object.__setattr__(self, f.name, int(v))
            elif isinstance(v, str) and v.strip().lstrip("+-").isdigit():
                object.__setattr__(self, f.name, int(v))
            else:
                raise ValueError(
                    f"parallelism.{f.name}: {v!r} is not an integer")

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "ParallelismSpec":
        """The spec of a ``KFTPU_PARALLELISM_JSON`` mapping; an unknown
        axis raises ``ValueError`` (the JAX model forbids extra keys)."""
        known = {f.name for f in dataclasses.fields(cls)}
        extra = sorted(set(d) - known)
        if extra:
            raise ValueError(f"unknown parallelism axes {extra}; known: "
                             f"{sorted(known)}")
        return cls(**d)

    @property
    def total(self) -> int:
        return (self.dcn * self.pipeline * self.data * self.fsdp
                * self.expert * self.seq * self.model)

    def axis_sizes(self) -> dict[str, int]:
        return {
            "dcn": self.dcn, "pipeline": self.pipeline, "data": self.data,
            "fsdp": self.fsdp, "expert": self.expert, "seq": self.seq,
            "model": self.model,
        }
