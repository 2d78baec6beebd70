"""Device-resident decode scheduler state (port of
``kubeflow_tpu/serve/device_state.py``; the LoRA adapter column arrives
with its slice).

The per-slot ``[B]`` state every decode dispatch reads lives on the device
for the engine's lifetime, uploaded in full once. Host-side scheduler
events (admission, reap/cancel, preemption) mark a slot DIRTY; right
before the next dispatch the engine writes each dirty slot's values as
per-element fills (the value rides as a kernel argument: no copy from
host memory, so no synchronisation with the device). The decode dispatch
consumes the state and returns the advanced state, which the engine
adopts, so a slot that decodes without host interference never syncs.

Paged engines also keep the ``[B, mpp]`` page table on the device. Table
growth, admission and release mark a ROW dirty; ``sync_rows`` uploads each
dirty row (``mpp`` int32 values) through pinned memory without waiting for
the device, so a page-table change costs one row, never the whole table,
and never stalls the scheduler behind a decode round in flight.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
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

    def __init__(self, num_slots: int, device: torch.device,
                 mpp: Optional[int] = None):
        self.num_slots = num_slots
        self.device = device
        self.arrays: dict[str, torch.Tensor] = {
            name: torch.full((num_slots,), DEAD_SLOT[i], dtype=_DTYPES[name],
                             device=device)
            for i, name in enumerate(STATE_FIELDS)}
        self.table: Optional[torch.Tensor] = None
        if mpp is not None:
            self.table = torch.full((num_slots, mpp), -1, dtype=torch.int32,
                                    device=device)
        # Upload accounting: "full" counts only construction; syncs grow
        # with scheduler events, never with steady-state decode rounds.
        self.stats = {"full_state_uploads": 1, "slot_syncs": 0}
        if mpp is not None:
            self.stats.update(full_table_uploads=1, table_row_syncs=0)
        self.dirty_slots: set[int] = set()
        self.dirty_rows: set[int] = set()

    def mark_slot(self, idx: int) -> None:
        self.dirty_slots.add(idx)

    def mark_row(self, idx: int) -> None:
        if self.table is not None:
            self.dirty_rows.add(idx)

    def sync_slots(self, values_for: Callable[[int], tuple]) -> None:  # hot-loop
        """Write every dirty slot's current host-side values
        (``values_for(idx)`` returns the STATE_FIELDS tuple; DEAD_SLOT for a
        freed slot)."""
        for idx in sorted(self.dirty_slots):
            for name, value in zip(STATE_FIELDS, values_for(idx)):
                self.arrays[name][idx].fill_(value)
            self.stats["slot_syncs"] += 1
        self.dirty_slots.clear()

    def sync_rows(self, row_for: Callable[[int], np.ndarray]) -> None:  # hot-loop
        """Upload every dirty page-table row (``row_for(idx)`` returns the
        host mirror's ``[mpp]`` row), each through pinned memory and
        without blocking."""
        if self.table is None:
            self.dirty_rows.clear()
            return
        for idx in sorted(self.dirty_rows):
            row = torch.from_numpy(np.array(row_for(idx), dtype=np.int32))
            if self.device.type != "cpu":
                row = row.pin_memory()
            self.table[idx].copy_(row, non_blocking=True)
            self.stats["table_row_syncs"] += 1
        self.dirty_rows.clear()

    def adopt(self, arrays: dict) -> None:
        """Swap in the advanced state a decode dispatch returned; deltas
        synced afterwards apply on top of it in stream order."""
        self.arrays = arrays
