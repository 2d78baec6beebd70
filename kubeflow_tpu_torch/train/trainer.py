"""The trainer loop a worker runs, plus its config (port of
``kubeflow_tpu/train/trainer.py``).

Ties together: the train state on the device, the data source, the step
loop with double-buffered input staging, checkpoint/resume with data
fast-forward over two tiers (interval and emergency; a save snapshots the
state and writes it while the loop runs on), SIGTERM as a
preemption notice (emergency save at the next step boundary, then
``SystemExit(EXIT_PREEMPTED)``), the step watchdog, the goodput ledger,
one ``train.window`` span per logged window, metric emission, and an
optional ``torch.profiler`` window. The JAX package's recompile sanitizer
has no counterpart: eager PyTorch does not compile per signature.

Spread over processes (a mesh from ``runtime.bootstrap``, one process per
device), each rank holds its shards of the state (``train/step.py``),
reads the data shard of its index over the batch axes (ranks that differ
only in ``seq`` read the same rows and cut their part of the sequence),
saves its blocks of each checkpoint (``train/checkpoint.py``), and only
the coordinator writes manifests, the goodput ledger and metrics.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import math
import os
import signal
import threading
import time
from typing import Optional

import torch

from kubeflow_tpu_torch.device import resolve_device
from kubeflow_tpu_torch.models.config import DecoderConfig, preset
from kubeflow_tpu_torch.obs.trace import get_tracer
from kubeflow_tpu_torch.parallel.fsdp import batch_index
from kubeflow_tpu_torch.train.checkpoint import (
    CheckpointManager, HostBuffers, ShardLayout, resume_from_tiers,
)
from kubeflow_tpu_torch.train.data import DataConfig, make_data_source
from kubeflow_tpu_torch.train.metrics import MetricsEmitter, Throughput
from kubeflow_tpu_torch.train.optim import OptimizerConfig
from kubeflow_tpu_torch.train.staging import (
    DeviceBatchStager, stage_inputs, to_device,
)
from kubeflow_tpu_torch.train.step import setup_train, trainable
from kubeflow_tpu_torch.train.survival import (
    EXIT_PREEMPTED, GoodputLedger, StepWatchdog,
)

logger = logging.getLogger("kubeflow_tpu_torch.train")


@dataclasses.dataclass
class TrainerConfig:
    model: str = "tiny"                       # preset name
    model_overrides: dict = dataclasses.field(default_factory=dict)
    optimizer: dict = dataclasses.field(default_factory=dict)
    data: dict = dataclasses.field(default_factory=dict)
    steps: int = 100
    log_every: int = 10
    # Input staging: staged into the workdir before the data pipeline
    # starts; a staged dataset switches the data kind to "text".
    dataset_uri: Optional[str] = None
    tokenizer_uri: Optional[str] = None
    train_tokenizer_vocab: Optional[int] = None
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 100
    max_checkpoints: int = 3
    # A preemption (SIGTERM) force-saves to a second tier at the next step
    # boundary, so a graceful preemption loses no completed step.
    emergency_checkpointing: bool = True
    emergency_checkpoint_dir: Optional[str] = None   # default: <ckpt>-emergency
    # Step-progress watchdog: a wedged step is detected within
    # max(min_seconds, multiplier x observed step time) and exits retryable.
    watchdog_enabled: bool = True
    watchdog_multiplier: float = 20.0
    watchdog_min_seconds: float = 60.0
    watchdog_startup_grace_seconds: float = 600.0
    # Chaos hooks: {"wedge_at_step": N, "wedge_once_file": path,
    # "save_fail_steps": [N, ...]}. Inert unless set.
    fault_injection: dict = dataclasses.field(default_factory=dict)
    seed: int = 0
    attn_impl: str = "xla"
    # The card's name for the MFU peak (``torch.cuda.get_device_name()``
    # when left None on a card; no MFU on the CPU).
    generation: Optional[str] = None
    # torch.profiler window: trace steps [profile_start_step,
    # profile_start_step + profile_num_steps) into <workdir>/trace.
    profile_start_step: Optional[int] = None
    profile_num_steps: int = 3
    # Debug mode: autograd anomaly detection names the op that produced a
    # NaN in the backward.
    debug_nans: bool = False

    @classmethod
    def from_dict(cls, d: dict) -> "TrainerConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


class Trainer:
    """Trains on the device of this process: alone (no ``mesh``), or as
    rank ``process_id`` of ``num_processes`` over ``mesh``, the
    ``DeviceMesh`` the worker's bootstrap built."""

    def __init__(self, cfg: TrainerConfig, mesh=None, *,
                 process_id: int = 0, num_processes: int = 1,
                 device: str | torch.device = "cuda",
                 metrics_path: Optional[str] = None,
                 workdir: Optional[str] = None):
        self.cfg = cfg
        self.mesh = mesh
        self.process_id = process_id
        self.num_processes = num_processes
        self.device = resolve_device(device)
        self.workdir = workdir
        coordinator = process_id == 0

        self.model_cfg: DecoderConfig = preset(cfg.model,
                                               **cfg.model_overrides)
        opt_cfg = OptimizerConfig.from_dict(
            {"total_steps": cfg.steps, **cfg.optimizer})
        data_overrides = dict(cfg.data)
        if cfg.dataset_uri:
            staged = stage_inputs(
                workdir or cfg.checkpoint_dir or ".",
                dataset_uri=cfg.dataset_uri,
                tokenizer_uri=cfg.tokenizer_uri,
                train_tokenizer_vocab=cfg.train_tokenizer_vocab)
            data_overrides.setdefault("kind", "text")
            data_overrides["path"] = staged["dataset"]
            if staged["tokenizer"]:
                data_overrides["tokenizer_path"] = staged["tokenizer"]
        data_cfg = DataConfig(**{
            "vocab_size": self.model_cfg.vocab_size,
            "seq_len": self.model_cfg.max_seq_len,
            **data_overrides,
        })
        if data_cfg.vocab_size > self.model_cfg.vocab_size:
            raise ValueError("data vocab exceeds model vocab")
        # The global batch must divide over the processes and the mesh's
        # batch axes: round it up to lcm(processes, batch shards), as JAX.
        shard, dp = batch_index(mesh)
        gran = math.lcm(max(num_processes, 1), max(dp, 1))
        if data_cfg.global_batch % gran:
            new_gb = -(-data_cfg.global_batch // gran) * gran
            logger.info(
                "global_batch %d not divisible by lcm(processes=%d, "
                "batch-shards=%d)=%d; adjusted to %d for this world shape",
                data_cfg.global_batch, num_processes, dp, gran, new_gb)
            data_cfg = dataclasses.replace(data_cfg, global_batch=new_gb)
        self.data_cfg = data_cfg
        self.data = make_data_source(data_cfg, shard=shard, num_shards=dp)

        self.task = setup_train(self.model_cfg, opt_cfg, device=self.device,
                                seed=cfg.seed, attn_impl=cfg.attn_impl,
                                mesh=mesh)
        self.shard_layout: Optional[ShardLayout] = None
        if self.task.layout is not None:
            lay = self.task.layout
            self.shard_layout = ShardLayout(
                sizes=lay.sizes, coords=lay.coords,
                specs=lay.state_specs(self.task.state),
                rank=process_id, world=num_processes)

        self.ckpt: Optional[CheckpointManager] = None
        self.ckpt_emergency: Optional[CheckpointManager] = None
        if cfg.checkpoint_dir:
            # Both tiers snapshot into one set of host buffers: a
            # preemption after an interval save pins no second copy.
            host = HostBuffers()
            self.ckpt = CheckpointManager(cfg.checkpoint_dir,
                                          cfg.max_checkpoints, host=host,
                                          layout=self.shard_layout)
            if cfg.emergency_checkpointing:
                self.ckpt_emergency = CheckpointManager(
                    cfg.emergency_checkpoint_dir
                    or f"{cfg.checkpoint_dir.rstrip(os.sep)}-emergency",
                    max_to_keep=1, host=host, layout=self.shard_layout)

        # Goodput ledger: coordinator-owned, in the workdir so it survives
        # restarts.
        ledger_dir = workdir or (os.path.dirname(metrics_path)
                                 if metrics_path else None)
        self.ledger: Optional[GoodputLedger] = (
            GoodputLedger(ledger_dir) if ledger_dir and coordinator
            else None)
        self.save_failures = 0
        self._preempted = threading.Event()
        self._watchdog: Optional[StepWatchdog] = None

        self.emitter = MetricsEmitter(
            jsonl_path=metrics_path if coordinator else None)
        card = cfg.generation
        if card is None and self.device.type == "cuda":
            card = torch.cuda.get_device_name(self.device)
        self.throughput = Throughput(
            tokens_per_step=data_cfg.global_batch * data_cfg.seq_len,
            num_chips=mesh.size() if mesh is not None else 1,
            flops_per_token=self.model_cfg.flops_per_token(),
            generation=card if self.device.type == "cuda" else None,
        )

    # -- checkpoint/resume -----------------------------------------------------

    def try_resume(self) -> int:
        """Restore the newest valid checkpoint across tiers (the emergency
        tier first on equal steps); returns the resume step. A corrupt or
        torn step is quarantined and the walk falls back to the next older
        one, each skip counted into ``restore_fallbacks``."""
        if self.ckpt is None:
            return 0
        tiers: list = []
        if self.ckpt_emergency is not None:
            tiers.append(("emergency", self.ckpt_emergency))
        tiers.append(("interval", self.ckpt))
        resumed = resume_from_tiers(tiers, device=self.device,
                                    layout=self.shard_layout,
                                    quarantine=self.process_id == 0)
        if resumed is None:
            return 0
        state, _, tier, fallbacks = resumed
        self.task.state = trainable(state)
        step = int(state["step"])
        if fallbacks and self.ledger is not None:
            self.ledger.record_fallback(fallbacks)
        logger.info("resumed from checkpoint at step %d (tier=%s, "
                    "fallbacks=%d)", step, tier, fallbacks)
        return step

    def save(self, step: int, *, force: bool = False,
             manager: Optional[CheckpointManager] = None) -> bool:
        """Save through ``manager`` (default: the interval tier): a
        snapshot of the state, written to disk in the background. A
        rejected or failed save is an alarm — logged and counted into
        ``checkpoint_save_failures`` — never a crash; a background write
        that failed is counted here, at the next save, or at ``_commit``."""
        mgr = manager if manager is not None else self.ckpt
        if mgr is None:
            return False
        with self._quiet():
            self._commit(mgr)
            return self._save(mgr, step, force)

    def _commit(self, mgr: CheckpointManager) -> bool:
        """Wait for ``mgr``'s save in flight; a failed one is logged and
        counted. Returns False when it failed."""
        with self._quiet():
            try:
                mgr.wait()
                return True
            except Exception:
                logger.exception("a checkpoint save failed in the "
                                 "background")
                self._count_save_failure()
                return False

    def _quiet(self):
        """The watchdog must not read a wait for a save as a wedge."""
        return (self._watchdog.suspended() if self._watchdog is not None
                else contextlib.nullcontext())

    def _count_save_failure(self) -> None:
        self.save_failures += 1
        if self.ledger is not None:
            self.ledger.record_save_failure()

    def _save(self, mgr: CheckpointManager, step: int, force: bool) -> bool:
        try:
            if step in set(self.cfg.fault_injection.get("save_fail_steps",
                                                        ())):
                raise OSError(f"injected checkpoint save failure at step "
                              f"{step}")
            accepted = mgr.save(step, self.task.state, force=force)
            if not accepted:
                logger.error("checkpoint save at step %d rejected by the "
                             "manager", step)
        except Exception:
            logger.exception("checkpoint save at step %d failed", step)
            accepted = False
        if not accepted:
            self._count_save_failure()
        return accepted

    # -- the loop --------------------------------------------------------------

    def run(self, *, on_step=None) -> dict:
        start = self.try_resume()
        if self.ledger is not None:
            lost = self.ledger.record_resume(start)
            if lost:
                logger.warning(
                    "restart lost %d completed step(s): last recorded "
                    "progress outran the resumed checkpoint", lost)
        last_metrics: dict = {}
        last_tick_step = start
        prof_start = self.cfg.profile_start_step
        profiler: Optional[torch.profiler.profile] = None
        tracer = get_tracer()
        window_start = time.time()
        watchdog: Optional[StepWatchdog] = None
        if self.cfg.watchdog_enabled:
            watchdog = StepWatchdog(
                multiplier=self.cfg.watchdog_multiplier,
                min_seconds=self.cfg.watchdog_min_seconds,
                startup_grace_seconds=self.cfg.watchdog_startup_grace_seconds)
            watchdog.start()
        self._watchdog = watchdog
        prev_sigterm = self._install_preemption_handler()
        # Batch N+1 is built and copied on a background thread (and a side
        # stream on a card) while step N runs. ``self.data`` reads this
        # rank's batch shard, which is its whole block of the global batch
        # (the decoder cuts its ``seq`` part after the input/target shift).
        side = (torch.cuda.Stream(self.device)
                if self.device.type == "cuda" else None)
        stager = DeviceBatchStager(
            lambda s: to_device(self.data.batch_at(s), self.device, side),
            start=start, name="train-batch-stager")
        anomaly = torch.autograd.set_detect_anomaly(self.cfg.debug_nans)
        # try/finally so any exit from the loop — an exception mid-window,
        # the preemption SystemExit — still stops an open profiler window,
        # the stager and the watchdog, and closes the emitter.
        try:
            for step in range(start, self.cfg.steps):
                if prof_start is not None:
                    # ``profiler`` guards both ends: a resume inside or
                    # past the window never stops a trace it did not start.
                    if step == prof_start:
                        profiler = self._start_profiler()
                    elif (profiler is not None and step
                          >= prof_start + self.cfg.profile_num_steps):
                        self._stop_profiler(profiler)
                        profiler = None
                batch = stager.get(step)
                self.task.state, metrics = self.task.step_fn(
                    self.task.state, batch)
                if watchdog is not None:
                    watchdog.step_completed(step + 1)
                if self._preempted.is_set():
                    self._emergency_exit(step + 1)      # raises SystemExit
                if ((step + 1) % self.cfg.log_every == 0
                        or step + 1 == self.cfg.steps):
                    metrics = {k: float(v) for k, v in metrics.items()}
                    metrics.update(self.throughput.tick(
                        step + 1 - last_tick_step))
                    if self.ckpt is not None:
                        committed = self.ckpt.latest_committed_step()
                        if committed is not None:
                            metrics["last_checkpoint_step"] = committed
                    metrics["checkpoint_save_failures"] = self.save_failures
                    if self.ledger is not None:
                        self.ledger.record_progress(step + 1)
                        metrics.update(self.ledger.metrics(
                            step + 1, self.throughput.ema_step_time_s))
                    # One completed span per logged window; ``profiling``
                    # marks windows that overlapped a profiler trace.
                    sp = tracer.start_span(
                        "train.window", start=window_start,
                        steps=f"{last_tick_step}-{step + 1}")
                    for k in ("loss", "step_time_ms", "tokens_per_sec",
                              "mfu"):
                        if k in metrics:
                            sp.set_attrs(**{k: round(float(metrics[k]), 6)})
                    if profiler is not None:
                        sp.set_attrs(profiling=True)
                    sp.end()
                    window_start = time.time()
                    last_tick_step = step + 1
                    last_metrics = metrics
                    self.emitter.emit(step + 1, metrics)
                if (self.cfg.checkpoint_every
                        and (step + 1) % self.cfg.checkpoint_every == 0):
                    self.save(step + 1)
                self._maybe_injected_wedge(step + 1)
                if on_step is not None:
                    on_step(step + 1, last_metrics)
            if self.ckpt is not None and \
                    self.ckpt.latest_step() != self.cfg.steps:
                self.save(self.cfg.steps, force=True)
        finally:
            anomaly.__exit__(None, None, None)
            stager.close()
            if prev_sigterm is not None:
                signal.signal(signal.SIGTERM, prev_sigterm)
            if watchdog is not None:
                watchdog.stop()
            self._watchdog = None
            if profiler is not None:
                try:
                    self._stop_profiler(profiler)
                except Exception:
                    logger.exception("stopping the profiler failed")
            for mgr in (self.ckpt, self.ckpt_emergency):
                if mgr is None:
                    continue
                self._commit(mgr)
                try:
                    mgr.close()
                except Exception:
                    logger.exception("checkpoint manager close failed")
            self.emitter.close()
        return last_metrics

    # -- survivability (preemption / wedge / chaos hooks) ----------------------

    def _install_preemption_handler(self):
        """SIGTERM = preemption notice, not an order to die mid-step: set a
        flag, emergency-save at the next step boundary, then exit. Main
        thread only (the signal module's rule); returns the previous
        handler for the finally-restore, or None when not installed."""
        if threading.current_thread() is not threading.main_thread():
            return None
        try:
            return signal.signal(signal.SIGTERM,
                                 lambda *_: self._preempted.set())
        except (ValueError, OSError) as exc:
            logger.warning("preemption handler not installed: %s", exc)
            return None

    def _emergency_exit(self, step: int) -> None:
        """A preemption landed: force-save the just-completed step to the
        emergency tier, record the ledger, and exit with the preempted code
        so the restart resumes at this exact step."""
        mgr = self.ckpt_emergency or self.ckpt
        saved = False
        if mgr is not None:
            saved = (self.save(step, force=True, manager=mgr)
                     and self._commit(mgr))
        if self.ledger is not None:
            self.ledger.record_progress(step)
            if saved:
                self.ledger.record_emergency_save(step)
        logger.warning(
            "preemption: emergency checkpoint at step %d (%s); exiting "
            "retryable", step, "saved" if saved else "SAVE FAILED")
        raise SystemExit(EXIT_PREEMPTED)

    def _maybe_injected_wedge(self, step: int) -> None:
        """Chaos hook: hang the loop at a configured step, for the watchdog
        to catch. ``wedge_once_file`` makes it fire on the first attempt
        only, so the restart that follows can prove the resume."""
        fi = self.cfg.fault_injection
        if fi.get("wedge_at_step") != step:
            return
        once = fi.get("wedge_once_file")
        if once:
            if os.path.exists(once):
                return
            with open(once, "w") as f:
                f.write(str(step))
        logger.warning("fault injection: wedging at step %d", step)
        while True:
            time.sleep(0.25)

    def _trace_dir(self) -> str:
        base = self.workdir or (os.path.dirname(self.emitter.jsonl_path)
                                if self.emitter.jsonl_path else ".")
        return os.path.join(base, "trace")

    def _start_profiler(self) -> torch.profiler.profile:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
        return prof

    def _stop_profiler(self, prof: torch.profiler.profile) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof.__exit__(None, None, None)
        os.makedirs(self._trace_dir(), exist_ok=True)
        prof.export_chrome_trace(os.path.join(
            self._trace_dir(), f"trace-{os.getpid()}-{int(time.time())}.json"))
