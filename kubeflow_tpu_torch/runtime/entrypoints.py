"""Entrypoint registry: what a worker runs (port of
``kubeflow_tpu/runtime/entrypoints.py``).

A ``WorkloadSpec.entrypoint`` names either a registered function here or
a "module:function" dotted path. The callable signature is
``fn(ctx: WorkerContext) -> int | None`` (None == 0).
"""

from __future__ import annotations

import dataclasses
import importlib
import time
from typing import Any, Callable, Optional

from kubeflow_tpu_torch.runtime.bootstrap import WorkerEnv, apply_platform


@dataclasses.dataclass
class WorkerContext:
    env: WorkerEnv
    heartbeat: Any = None        # Heartbeat | None
    _device: Optional[str] = None
    _mesh: Any = None
    _joined: bool = False

    @property
    def config(self) -> dict[str, Any]:
        return self.env.config

    @property
    def is_coordinator(self) -> bool:
        return self.env.process_id == 0

    @property
    def mesh(self):
        """The mesh of a multi-process or sharded worker, None for a
        single process without a ``parallelism``: the world is joined on
        first use (``bootstrap_worker``), so an entrypoint that never asks
        (``torch_train``, which makes its own gloo group; a control-plane
        entrypoint) joins nothing."""
        if not self._joined:
            from kubeflow_tpu_torch.runtime.bootstrap import bootstrap_worker

            _, self._mesh = bootstrap_worker(self.env)
            self._joined = True
        return self._mesh

    @property
    def device(self) -> str:
        """The resolved device (``apply_platform``), on first use: a
        control-plane entrypoint that never asks never touches a card."""
        if self._device is None:
            self._device = apply_platform(self.env)
        return self._device


EntrypointFn = Callable[[WorkerContext], Optional[int]]

_registry: dict[str, EntrypointFn] = {}


def register_entrypoint(name: str):
    def deco(fn: EntrypointFn) -> EntrypointFn:
        _registry[name] = fn
        return fn
    return deco


def resolve_handler(handler: str, registry: dict, what: str) -> Callable:
    """A registered name from ``registry``, or a "module:function" path
    (the transformer, explainer and tokenizer forms of a worker config)."""
    if handler in registry:
        return registry[handler]
    module, sep, attr = handler.partition(":")
    if not sep:
        raise KeyError(
            f"{what} {handler!r} is not registered and is not a "
            f"'module:function' path; registered: {sorted(registry)}")
    return getattr(importlib.import_module(module), attr)


def resolve_entrypoint(name: str) -> EntrypointFn:
    # Trivial built-ins resolve without the serving stack's (torch) import:
    # keeps control-plane workers light and promptly signal-responsive.
    if name in _registry:
        return _registry[name]
    _ensure_builtin()
    if name in _registry:
        return _registry[name]
    if ":" in name:
        module, attr = name.split(":", 1)
        fn = getattr(importlib.import_module(module), attr)
        return fn
    raise KeyError(f"unknown entrypoint {name!r}; registered: {sorted(_registry)}")


def _ensure_builtin() -> None:
    # The trainer (llm_pretrain, vision_train), adapter (torch_train) and
    # serving (model_server) entrypoints self-register on import.
    import kubeflow_tpu_torch.serve.model_server  # noqa: F401
    import kubeflow_tpu_torch.train.adapters  # noqa: F401
    import kubeflow_tpu_torch.train.entrypoints  # noqa: F401


# -- trivial built-ins used by tests and smoke runs ----------------------------

@register_entrypoint("noop")
def noop(ctx: WorkerContext) -> int:
    return 0


@register_entrypoint("sleep")
def sleep(ctx: WorkerContext) -> int:
    time.sleep(float(ctx.config.get("seconds", 1.0)))
    return 0


@register_entrypoint("fail")
def fail(ctx: WorkerContext) -> int:
    return int(ctx.config.get("exit_code", 1))


@register_entrypoint("objective_probe")
def objective_probe(ctx: WorkerContext) -> int:
    """Synthetic HPO objective: writes a decaying metrics.jsonl series ending
    at (x-x0)^2 + (y-y0)^2 — lets tune e2e tests optimize a known bowl."""
    import json
    import os

    x = float(ctx.config.get("x", 0.0))
    y = float(ctx.config.get("y", 0.0))
    x0 = float(ctx.config.get("x0", 0.3))
    y0 = float(ctx.config.get("y0", -0.2))
    steps = int(ctx.config.get("steps", 3))
    final = (x - x0) ** 2 + (y - y0) ** 2
    if ctx.env.workdir:
        path = os.path.join(ctx.env.workdir, "metrics.jsonl")
        with open(path, "w") as f:
            for s in range(steps):
                v = final + (steps - 1 - s) * 0.1
                f.write(json.dumps({"step": s, "objective": v}) + "\n")
    return 0


@register_entrypoint("flaky")
def flaky(ctx: WorkerContext) -> int:
    """Fails with a retryable code until attempt file reaches a threshold —
    used to test ExitCode restart semantics deterministically."""
    import os

    path = ctx.config["attempt_file"]
    fail_times = int(ctx.config.get("fail_times", 1))
    n = 0
    if os.path.exists(path):
        n = int(open(path).read() or 0)
    open(path, "w").write(str(n + 1))
    if n < fail_times:
        return int(ctx.config.get("exit_code", 130))  # retryable (>=128)
    return 0
