"""Slice topology model (port of ``kubeflow_tpu/runtime/topology.py``).

Generations, slices and their host/chip structure, and the local
environment detected as a one-slice cluster. The generation table is the
JAX package's, unchanged; ``detect_local_cluster`` counts the CUDA cards
torch sees and names the generation as the JAX function does ("cpu"
without a card, "sim" with one).
"""

from __future__ import annotations

import dataclasses
import logging
import math
from typing import Optional

logger = logging.getLogger("kubeflow_tpu_torch.runtime")


@dataclasses.dataclass(frozen=True)
class ChipGeneration:
    """Hardware constants per TPU generation (public figures)."""

    name: str
    hbm_gb: float
    bf16_tflops: float           # peak dense bf16 TFLOP/s per chip
    chips_per_host: int
    torus_dims: int              # 3 for v4/v5p (3D torus), 2 for v5e/v6e


GENERATIONS: dict[str, ChipGeneration] = {
    "v4": ChipGeneration(name="v4", hbm_gb=32, bf16_tflops=275, chips_per_host=4, torus_dims=3),
    "v5e": ChipGeneration(name="v5e", hbm_gb=16, bf16_tflops=197, chips_per_host=4, torus_dims=2),
    "v5p": ChipGeneration(name="v5p", hbm_gb=95, bf16_tflops=459, chips_per_host=4, torus_dims=3),
    "v6e": ChipGeneration(name="v6e", hbm_gb=32, bf16_tflops=918, chips_per_host=4, torus_dims=2),
    "sim": ChipGeneration(name="sim", hbm_gb=16, bf16_tflops=197, chips_per_host=8, torus_dims=2),
    "cpu": ChipGeneration(name="cpu", hbm_gb=4, bf16_tflops=0.1, chips_per_host=8, torus_dims=2),
}


@dataclasses.dataclass
class SliceTopology:
    """One slice: a contiguous interconnect domain (e.g. 4x4x4, 4x2)."""

    name: str
    generation: str = "v5e"
    dims: tuple[int, ...] = (1,)

    def __post_init__(self):
        if self.generation not in GENERATIONS:
            raise ValueError(f"unknown generation {self.generation!r}; "
                             f"known: {sorted(GENERATIONS)}")
        self.dims = tuple(int(d) for d in self.dims)

    @property
    def num_chips(self) -> int:
        return math.prod(self.dims)

    @property
    def gen(self) -> ChipGeneration:
        return GENERATIONS[self.generation]

    @property
    def num_hosts(self) -> int:
        return max(1, self.num_chips // self.gen.chips_per_host)

    @classmethod
    def parse(cls, name: str, spec: str,
              generation: str = "v5e") -> "SliceTopology":
        """Parse "4x4x4"-style topology strings."""
        dims = tuple(int(d) for d in spec.lower().split("x"))
        if not dims or any(d < 1 for d in dims):
            raise ValueError(f"bad topology spec {spec!r}")
        return cls(name=name, generation=generation, dims=dims)


@dataclasses.dataclass
class Cluster:
    """Inventory of slices available to the control plane."""

    slices: list[SliceTopology]

    @property
    def total_chips(self) -> int:
        return sum(s.num_chips for s in self.slices)

    def get_slice(self, name: str) -> Optional[SliceTopology]:
        for s in self.slices:
            if s.name == name:
                return s
        return None


def detect_local_cluster(num_chips: Optional[int] = None,
                         generation: Optional[str] = None) -> Cluster:
    """The local environment as a one-slice cluster: ``num_chips``
    defaults to the CUDA cards torch sees (the generation "sim" then, as
    the JAX function names an accelerator), or one "cpu" chip without a
    card; both are overridable."""
    if num_chips is None:
        try:
            import torch

            count = torch.cuda.device_count()
            num_chips = count or 1
            generation = generation or ("sim" if count else "cpu")
        except Exception:
            logger.exception(
                "device probe failed; assuming a 1-chip sim cluster")
            num_chips = 1
            generation = generation or "sim"
    generation = generation or "sim"
    # Factor the chip count into a near-square 2D shape.
    a = int(math.sqrt(num_chips))
    while a > 1 and num_chips % a:
        a -= 1
    dims = (a, num_chips // a) if a > 1 else (num_chips,)
    return Cluster(slices=[SliceTopology(name="local", generation=generation,
                                         dims=dims)])
