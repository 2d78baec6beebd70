"""Worker-side bootstrap (port of ``kubeflow_tpu/runtime/bootstrap.py``):
the ``KFTPU_*`` environment contract a control plane hands a worker
process, the exit codes it answers with, and the heartbeat file.

    KFTPU_COORDINATOR_ADDRESS  worker-0's host:port
    KFTPU_NUM_PROCESSES        world size
    KFTPU_PROCESS_ID           this worker's rank
    KFTPU_JOB                  owning job "namespace/name"
    KFTPU_REPLICA_INDEX        replica index
    KFTPU_ENTRYPOINT           registered entrypoint or "module:function"
    KFTPU_CONFIG_JSON          entrypoint config (JSON)
    KFTPU_PARALLELISM_JSON     mesh axis sizes (JSON)
    KFTPU_PLATFORM             "cpu" (the plain path); anything else, or
                               unset, = the card
    KFTPU_VIRTUAL_DEVICES      kept for the JAX contract; unused here
    KFTPU_HEARTBEAT_FILE       file this worker touches every few seconds
    KFTPU_WORKDIR              working/checkpoint directory

``apply_platform`` resolves the device: ``"cpu"`` only when the platform
says so, otherwise CUDA, which raises without a card. ``bootstrap_worker``
joins the world of a worker with more than one process or a
``parallelism``: a ``torch.distributed`` process group over
``tcp://{coordinator_address}`` (``nccl`` on the card, ``gloo`` for
``KFTPU_PLATFORM=cpu``; the backend follows the platform, never what is
found), one device per process (rank r on ``cuda:{r % device_count}``),
and the 7-axis mesh (``runtime/mesh.py``) over it; a rendezvous that fails
or times out exits ``EXIT_RETRYABLE``. A single-process worker without a
parallelism is control-plane only and never imports torch here. Nothing
here imports JAX or sets ``XLA_FLAGS``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from typing import Any, Optional

# Exit-code contract (RestartPolicy=ExitCode semantics: retryable >= 128,
# permanent < 128).
EXIT_OK = 0
EXIT_PERMANENT = 1
EXIT_CONFIG_ERROR = 2
EXIT_RETRYABLE = 128
EXIT_PREEMPTED = 143  # SIGTERM


@dataclasses.dataclass
class WorkerEnv:
    coordinator_address: str
    num_processes: int
    process_id: int
    job: str
    replica_index: int
    entrypoint: str
    config: dict[str, Any]
    parallelism: dict[str, int]
    platform: Optional[str] = None      # None (unset): the card
    virtual_devices: int = 1
    heartbeat_file: Optional[str] = None
    workdir: Optional[str] = None
    rendezvous_timeout_seconds: float = 60.0

    def to_env(self) -> dict[str, str]:
        return {
            "KFTPU_COORDINATOR_ADDRESS": self.coordinator_address,
            "KFTPU_NUM_PROCESSES": str(self.num_processes),
            "KFTPU_PROCESS_ID": str(self.process_id),
            "KFTPU_JOB": self.job,
            "KFTPU_REPLICA_INDEX": str(self.replica_index),
            "KFTPU_ENTRYPOINT": self.entrypoint,
            "KFTPU_CONFIG_JSON": json.dumps(self.config),
            "KFTPU_PARALLELISM_JSON": json.dumps(self.parallelism),
            "KFTPU_VIRTUAL_DEVICES": str(self.virtual_devices),
            "KFTPU_RENDEZVOUS_TIMEOUT": str(self.rendezvous_timeout_seconds),
            **({"KFTPU_PLATFORM": self.platform} if self.platform else {}),
            **({"KFTPU_HEARTBEAT_FILE": self.heartbeat_file} if self.heartbeat_file else {}),
            **({"KFTPU_WORKDIR": self.workdir} if self.workdir else {}),
        }

    @classmethod
    def from_env(cls, env: Optional[dict[str, str]] = None) -> "WorkerEnv":
        e = env if env is not None else os.environ
        try:
            return cls(
                coordinator_address=e["KFTPU_COORDINATOR_ADDRESS"],
                num_processes=int(e["KFTPU_NUM_PROCESSES"]),
                process_id=int(e["KFTPU_PROCESS_ID"]),
                job=e.get("KFTPU_JOB", "default/unknown"),
                replica_index=int(e.get("KFTPU_REPLICA_INDEX", e["KFTPU_PROCESS_ID"])),
                entrypoint=e["KFTPU_ENTRYPOINT"],
                config=json.loads(e.get("KFTPU_CONFIG_JSON", "{}")),
                parallelism=json.loads(e.get("KFTPU_PARALLELISM_JSON", "{}")),
                platform=e.get("KFTPU_PLATFORM"),
                virtual_devices=int(e.get("KFTPU_VIRTUAL_DEVICES", "1")),
                heartbeat_file=e.get("KFTPU_HEARTBEAT_FILE"),
                workdir=e.get("KFTPU_WORKDIR"),
                rendezvous_timeout_seconds=float(e.get("KFTPU_RENDEZVOUS_TIMEOUT", "60")),
            )
        except (KeyError, ValueError) as exc:
            raise SystemExit(EXIT_CONFIG_ERROR) from exc


class Heartbeat:
    """Touches a file every ``interval`` seconds from a daemon thread; the
    controller declares a worker dead when the file's mtime goes stale."""

    def __init__(self, path: str, interval: float = 2.0):
        self.path = path
        self.interval = interval
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        self.beat()
        self._thread = threading.Thread(target=self._run, daemon=True, name="heartbeat")
        self._thread.start()

    def beat(self) -> None:
        with open(self.path, "w") as f:
            f.write(str(time.time()))

    def _run(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self.beat()
            except OSError:
                pass

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self.interval + 1.0)
            self._thread = None


def apply_platform(wenv: Optional[WorkerEnv]) -> str:
    """The device a worker's compute runs on: ``"cpu"`` when the platform
    says so, else (another value, or none set) the card, which raises
    without one (a worker never moves to the CPU on its own). Torch is imported here, not at module import,
    so control-plane entrypoints start light."""
    if wenv is not None and wenv.platform == "cpu":
        return "cpu"
    import torch

    if not torch.cuda.is_available():
        platform = wenv.platform if wenv else None
        named = (f"KFTPU_PLATFORM={platform!r}" if platform
                 else "an unset KFTPU_PLATFORM")
        raise RuntimeError(
            f"{named} needs a CUDA device and none is available; set "
            "KFTPU_PLATFORM=cpu to run the plain path on the CPU")
    from kubeflow_tpu_torch.device import resolve_device

    return str(resolve_device("cuda"))


#: The mesh this process joined (one world per process).
_MESH = None


def bootstrap_worker(wenv: Optional[WorkerEnv] = None):
    """Join the world and build the mesh; returns ``(env, mesh)``.

    A worker with one process and no ``parallelism`` is control-plane only:
    ``(env, None)``, and torch is not imported. Otherwise the worker
    resolves its device (``apply_platform``: a ``gpu`` worker without a
    card raises), joins the process group (a world of one too, so one card
    runs the code many do) and returns the mesh of its ``parallelism``
    (all processes on ``fsdp`` when the job pins no axes,
    ``runtime.mesh.infer_parallelism``). Idempotent: a second call returns
    the mesh the first built."""
    wenv = wenv or WorkerEnv.from_env()
    if wenv.num_processes == 1 and not wenv.parallelism:
        return wenv, None
    global _MESH
    if _MESH is not None:
        return wenv, _MESH
    import datetime

    import torch
    import torch.distributed as dist

    from kubeflow_tpu_torch.core.jobs import ParallelismSpec
    from kubeflow_tpu_torch.runtime.mesh import (
        build_mesh, infer_parallelism,
    )

    spec = (ParallelismSpec.from_dict(wenv.parallelism) if wenv.parallelism
            else infer_parallelism(wenv.num_processes))
    on_card = wenv.platform != "cpu"
    apply_platform(wenv)
    if on_card:
        torch.cuda.set_device(wenv.process_id % torch.cuda.device_count())
    try:
        dist.init_process_group(
            "nccl" if on_card else "gloo",
            init_method=f"tcp://{wenv.coordinator_address}",
            world_size=wenv.num_processes, rank=wenv.process_id,
            timeout=datetime.timedelta(
                seconds=wenv.rendezvous_timeout_seconds))
    except Exception as exc:
        # A partial gang (a missing peer, a dead coordinator) is transient
        # at the job level: exit retryable so the controller re-gangs.
        print(f"rendezvous failed: {type(exc).__name__}: {exc}", flush=True)
        raise SystemExit(EXIT_RETRYABLE)
    _MESH = build_mesh(spec.axis_sizes(), "cuda" if on_card else "cpu")
    return wenv, _MESH


def shutdown_worker() -> None:
    """Leave the process group, if this worker joined one."""
    global _MESH
    import sys

    dist = sys.modules.get("torch.distributed")
    if dist is not None and dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    _MESH = None


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]
