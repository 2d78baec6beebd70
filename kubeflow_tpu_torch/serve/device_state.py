"""Device-resident decode scheduler state (port of
``kubeflow_tpu/serve/device_state.py``, contiguous-cache half).

The per-slot ``[B]`` state every decode dispatch reads lives on the device
for the engine's lifetime, uploaded in full once. Host-side scheduler
events (admission, reap/cancel, preemption) mark a slot DIRTY; right
before the next dispatch the engine writes each dirty slot's values as
per-element fills (the value rides as a kernel argument: no copy from
host memory, so no synchronisation with the device). The decode dispatch
consumes the state and returns the advanced state, which the engine
adopts, so a slot that decodes without host interference never syncs.

The paged page table and the LoRA adapter column arrive with their slices.
"""

from __future__ import annotations

from typing import Callable

import torch

#: Per-slot scheduler state riding into every decode dispatch, in sync
#: order. ``tokens`` = last sampled token (the next step's input);
#: ``lengths`` = its KV write position; ``live`` masks dead rows; the rest
#: are per-slot sampling params and the remaining token budget.
STATE_FIELDS = ("tokens", "lengths", "live", "temps", "top_k", "top_p",
                "stops", "budgets")

_DTYPES = {"tokens": torch.int64, "lengths": torch.int64,
           "live": torch.bool, "temps": torch.float32, "top_k": torch.int64,
           "top_p": torch.float32, "stops": torch.int64,
           "budgets": torch.int64}

#: Values a freed slot syncs back to (live=False is the one that matters —
#: a dead row's other fields are never read by the dispatch).
DEAD_SLOT = (0, 0, False, 0.0, 0, 1.0, -1, 0)


class DecodeState:
    """Persistent on-device scheduler state + dirty-slot delta sync.

    ``arrays`` maps each of ``STATE_FIELDS`` to a ``[B]`` device tensor;
    ``adopt()`` swaps in a dispatch's returned state; ``mark_slot`` /
    ``sync_slots`` apply host-side scheduler deltas per slot."""

    def __init__(self, num_slots: int, device: torch.device):
        self.num_slots = num_slots
        self.arrays: dict[str, torch.Tensor] = {
            name: torch.full((num_slots,), DEAD_SLOT[i], dtype=_DTYPES[name],
                             device=device)
            for i, name in enumerate(STATE_FIELDS)}
        # Upload accounting: "full" counts only construction; slot syncs grow
        # with scheduler events, never with steady-state decode rounds.
        self.stats = {"full_state_uploads": 1, "slot_syncs": 0}
        self.dirty_slots: set[int] = set()

    def mark_slot(self, idx: int) -> None:
        self.dirty_slots.add(idx)

    def sync_slots(self, values_for: Callable[[int], tuple]) -> None:  # hot-loop
        """Write every dirty slot's current host-side values
        (``values_for(idx)`` returns the STATE_FIELDS tuple; DEAD_SLOT for a
        freed slot)."""
        for idx in sorted(self.dirty_slots):
            for name, value in zip(STATE_FIELDS, values_for(idx)):
                self.arrays[name][idx].fill_(value)
            self.stats["slot_syncs"] += 1
        self.dirty_slots.clear()

    def adopt(self, arrays: dict) -> None:
        """Swap in the advanced state a decode dispatch returned; deltas
        synced afterwards apply on top of it in stream order."""
        self.arrays = arrays
