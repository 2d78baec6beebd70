"""Training survivability: the goodput ledger, the step-progress watchdog
and the stack dump (port of ``kubeflow_tpu/train/survival.py``).

- ``GoodputLedger``: a small JSON file in the job workdir that survives
  restarts. It accumulates attempts, steps lost to each restart (last
  recorded progress vs. the step actually resumed), emergency saves,
  restore fallbacks and failed checkpoint saves, and computes goodput
  (useful step time over wall time) from them. The trainer folds
  ``ledger.metrics()`` into every metrics window.
- ``StepWatchdog``: a daemon thread that detects a wedged train step (a
  hung device call, a stuck input pipeline) within a multiple of the
  observed step time, dumps every thread's stack and exits with the
  retryable code.

The exit codes are the worker bootstrap's (``kubeflow_tpu/runtime/
bootstrap.py``), copied: the port does not import the JAX package.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import sys
import threading
import time
import traceback
from typing import Callable, Optional

#: A retryable failure: the gang-restart machinery restarts the job.
EXIT_RETRYABLE = 128
#: Preempted (SIGTERM): emergency-saved, resume from the newest step.
EXIT_PREEMPTED = 143

logger = logging.getLogger("kubeflow_tpu_torch.train.survival")

LEDGER_FILENAME = "goodput.json"


class GoodputLedger:
    """Restart-surviving goodput accounting for one job workdir.

    Single-writer by contract: only the coordinator process holds a
    ledger, and attempts of a job are sequential, so plain
    read-modify-write is safe. Every mutation persists immediately — the
    next write may never come."""

    _COUNTERS = ("attempts", "steps_lost_total", "emergency_saves",
                 "restore_fallbacks", "checkpoint_save_failures")

    def __init__(self, workdir: str):
        self.path = os.path.join(workdir, LEDGER_FILENAME)
        self.data: dict = {
            "wall_start": None,       # first attempt's start (epoch seconds)
            "last_step": 0,           # newest progress any attempt recorded
            "attempts": 0,
            "steps_lost_total": 0,
            "emergency_saves": 0,
            "restore_fallbacks": 0,
            "checkpoint_save_failures": 0,
        }
        try:
            with open(self.path) as f:
                self.data.update(json.load(f))
        except (OSError, ValueError):
            pass

    def _persist(self) -> None:
        tmp = f"{self.path}.tmp"
        try:
            with open(tmp, "w") as f:
                json.dump(self.data, f)
            os.replace(tmp, self.path)
        except OSError:
            logger.warning("goodput ledger write failed: %s", self.path,
                           exc_info=True)

    # -- lifecycle events ------------------------------------------------------

    def record_resume(self, resume_step: int) -> int:
        """A new attempt started, resuming at ``resume_step``. Returns the
        steps this restart lost (progress the previous attempt recorded but
        the resumed state does not contain — work that must be redone)."""
        if self.data["wall_start"] is None:
            self.data["wall_start"] = time.time()
        lost = max(0, int(self.data["last_step"]) - int(resume_step))
        self.data["attempts"] += 1
        self.data["steps_lost_total"] += lost
        self.data["last_step"] = int(resume_step)
        self._persist()
        return lost

    def record_progress(self, step: int) -> None:
        self.data["last_step"] = max(int(self.data["last_step"]), int(step))
        self._persist()

    def record_emergency_save(self, step: int) -> None:
        self.data["emergency_saves"] += 1
        self.data["last_step"] = max(int(self.data["last_step"]), int(step))
        self._persist()

    def record_fallback(self, n: int = 1) -> None:
        self.data["restore_fallbacks"] += int(n)
        self._persist()

    def record_save_failure(self) -> None:
        self.data["checkpoint_save_failures"] += 1
        self._persist()

    # -- the metric ------------------------------------------------------------

    def goodput(self, step: int, step_time_s: Optional[float],
                now: Optional[float] = None) -> Optional[float]:
        """Useful step-time over wall time, capped at 1.0.

        ``step * step_time_s`` approximates the time the surviving progress
        *should* have cost at the observed steady step time; everything else
        the job spent — compile, restart downtime, redone (lost) steps,
        checkpoint stalls — is the goodput gap. None until a steady step
        time exists."""
        if not step_time_s or self.data["wall_start"] is None:
            return None
        wall = (now if now is not None else time.time()) - self.data["wall_start"]
        if wall <= 0:
            return None
        return min(1.0, (int(step) * float(step_time_s)) / wall)

    def metrics(self, step: int, step_time_s: Optional[float]) -> dict:
        """The ledger as metrics.jsonl fields."""
        out = {k: int(self.data[k]) for k in self._COUNTERS}
        gp = self.goodput(step, step_time_s)
        if gp is not None:
            out["goodput"] = round(gp, 4)
        return out


def dump_all_stacks(out=None) -> None:
    """Every thread's Python stack to ``out`` (default stderr) — the
    wedge post-mortem, written while the process is still alive to write
    it."""
    out = out or sys.stderr
    names = {t.ident: t.name for t in threading.enumerate()}
    for tid, frame in sys._current_frames().items():
        print(f"--- thread {names.get(tid, '?')} ({tid}) ---",
              file=out, flush=False)
        traceback.print_stack(frame, file=out)
    out.flush()


class StepWatchdog:
    """Detects a wedged train loop from inside the worker.

    Armed when the loop starts, fed a monotonic timestamp per completed
    step. The stall threshold adapts to the *observed* step time
    (``multiplier`` x EMA, floored at ``min_seconds``); before the first
    step completes — the first step builds the kernels —
    ``startup_grace_seconds`` applies instead. On a stall it dumps every
    thread's stack and calls ``exit_fn`` (default ``os._exit`` with the
    retryable code, because a wedged main thread by definition cannot run
    cleanup — the gang restart is the cleanup)."""

    def __init__(self, *, multiplier: float = 20.0, min_seconds: float = 60.0,
                 startup_grace_seconds: float = 600.0,
                 poll_seconds: float = 0.25,
                 exit_fn: Optional[Callable[[int], None]] = None,
                 on_stall: Optional[Callable[[float], None]] = None):
        self.multiplier = multiplier
        self.min_seconds = min_seconds
        self.startup_grace_seconds = startup_grace_seconds
        self.poll_seconds = poll_seconds
        self.exit_fn = exit_fn or os._exit
        self.on_stall = on_stall
        # lockfree: single-writer latch; readers only observe False->True
        self.fired = False
        self._ema_dt: Optional[float] = None
        self._last_progress = time.monotonic()
        self._last_step = 0
        self._stop = threading.Event()
        self._suspended = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self._last_progress = time.monotonic()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="step-watchdog")
        self._thread.start()

    def step_completed(self, step: int) -> None:
        now = time.monotonic()
        dt = now - self._last_progress
        self._ema_dt = dt if self._ema_dt is None \
            else 0.8 * self._ema_dt + 0.2 * dt
        self._last_progress = now
        self._last_step = step

    @contextlib.contextmanager
    def suspended(self):
        """No stall is counted inside the block (a synchronous checkpoint
        save is progress, not a wedge); the clock restarts at its end."""
        self._suspended.set()
        try:
            yield
        finally:
            self._last_progress = time.monotonic()
            self._suspended.clear()

    def threshold(self) -> float:
        if self._ema_dt is None:
            return self.startup_grace_seconds
        return max(self.min_seconds, self.multiplier * self._ema_dt)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)

    def _run(self) -> None:
        while not self._stop.wait(self.poll_seconds):
            if self._suspended.is_set():
                continue
            stalled = time.monotonic() - self._last_progress
            limit = self.threshold()
            if stalled <= limit:
                continue
            self.fired = True
            logger.error(
                "watchdog: no step progress for %.1fs (limit %.1fs, last "
                "step %d) — dumping stacks and exiting retryable",
                stalled, limit, self._last_step)
            try:
                dump_all_stacks()
            except Exception:   # the dump is best-effort; the exit is not
                logger.exception("watchdog stack dump failed")
            if self.on_stall is not None:
                try:
                    self.on_stall(stalled)
                except Exception:
                    logger.exception("watchdog on_stall hook failed")
            self.exit_fn(EXIT_RETRYABLE)
            return
