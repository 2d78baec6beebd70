"""Worker process entry: ``python -m kubeflow_tpu_torch.runtime.worker_main``
(port of ``kubeflow_tpu/runtime/worker_main.py``).

Reads the ``KFTPU_*`` env, starts the heartbeat, resolves and runs the
entrypoint, and exits with the contract code: 0 ok, 1 permanent, 2 a
config error or an unknown entrypoint, 128 a lost peer or a failed
rendezvous (retryable), 143 on SIGTERM (a preemption, retryable). An
entrypoint joins the world when it first asks for the mesh
(``WorkerContext.mesh`` → ``bootstrap_worker``); the worker leaves it on
exit.
"""

from __future__ import annotations

import logging
import os
import signal
import sys
import traceback


def main() -> int:
    logging.basicConfig(
        # contract: operator-facing knob — set by the user, never by the tree
        level=os.environ.get("KFTPU_LOG_LEVEL", "INFO"),
        format="%(asctime)s %(name)s [w%(process)d] %(message)s",
        stream=sys.stderr,
    )
    from kubeflow_tpu_torch.runtime.bootstrap import (
        EXIT_CONFIG_ERROR, EXIT_PREEMPTED, Heartbeat, WorkerEnv,
        shutdown_worker,
    )
    from kubeflow_tpu_torch.runtime.entrypoints import (
        WorkerContext, resolve_entrypoint,
    )

    # SIGTERM → exit 143 (retryable): a preemption, not a program bug.
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(EXIT_PREEMPTED))

    wenv = WorkerEnv.from_env()
    hb = None
    if wenv.heartbeat_file:
        hb = Heartbeat(wenv.heartbeat_file)
        hb.start()
    if wenv.workdir:
        os.makedirs(wenv.workdir, exist_ok=True)
        os.chdir(wenv.workdir)

    try:
        fn = resolve_entrypoint(wenv.entrypoint)
    except Exception:
        traceback.print_exc()
        return EXIT_CONFIG_ERROR

    try:
        ctx = WorkerContext(env=wenv, heartbeat=hb)
        rc = fn(ctx)
        # Leave the world on the way out of a run that ended well (a lost
        # peer could hang the teardown of a failed one; exit ends it).
        shutdown_worker()
        return 0 if rc is None else int(rc)
    except SystemExit as e:
        return int(e.code or 0)
    except Exception as exc:
        traceback.print_exc()
        return _classify_exit(exc)
    finally:
        if hb is not None:
            hb.stop()


def _classify_exit(exc: BaseException) -> int:
    """Exit code for an entrypoint's exception. A lost peer, an aborted
    collective or a store that went away (``torch.distributed``'s
    ``DistBackendError`` — the NCCL watchdog's timeout among them —
    ``DistNetworkError`` and ``DistStoreError``) is infrastructure: exit
    retryable so the controller re-gangs. Everything else is
    deterministic — ``torch.OutOfMemoryError``, a shape or value error, a
    missing card, a bad checkpoint, a program bug — and a restart would
    fail the same way: permanent (JAX's RESOURCE_EXHAUSTED /
    INVALID_ARGUMENT split). Matched by exact type, never by message."""
    from kubeflow_tpu_torch.runtime.bootstrap import (
        EXIT_PERMANENT, EXIT_RETRYABLE,
    )

    dist = sys.modules.get("torch.distributed")
    if dist is None:
        return EXIT_PERMANENT
    infra = {getattr(dist, n, None) for n in (
        "DistBackendError", "DistNetworkError", "DistStoreError")}
    return EXIT_RETRYABLE if type(exc) in infra - {None} else EXIT_PERMANENT


if __name__ == "__main__":
    sys.exit(main())
