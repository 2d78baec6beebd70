"""Worker process entry: ``python -m kubeflow_tpu_torch.runtime.worker_main``
(port of ``kubeflow_tpu/runtime/worker_main.py``).

Reads the ``KFTPU_*`` env, starts the heartbeat, checks the world
(``bootstrap_worker``), resolves and runs the entrypoint, and exits with
the contract code: 0 ok, 1 permanent, 2 a config error or an unknown
entrypoint, 143 on SIGTERM (a preemption, retryable).
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
        bootstrap_worker,
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
        ctx = WorkerContext(env=bootstrap_worker(wenv), heartbeat=hb)
        rc = fn(ctx)
        return 0 if rc is None else int(rc)
    except SystemExit as e:
        return int(e.code or 0)
    except Exception as exc:
        traceback.print_exc()
        return _classify_exit(exc)
    finally:
        if hb is not None:
            hb.stop()


def _classify_exit(exc: Exception) -> int:
    """Exit code for an entrypoint's exception. A one-card worker's
    failures are deterministic — ``torch.cuda.OutOfMemoryError``, a shape
    error (``RuntimeError``/``ValueError``), a missing card, a bad
    checkpoint, a program bug — and a restart would fail the same way, so
    each is permanent. The retryable class (a lost peer, an aborted
    collective) arrives with multi-GPU workers."""
    from kubeflow_tpu_torch.runtime.bootstrap import EXIT_PERMANENT

    return EXIT_PERMANENT


if __name__ == "__main__":
    sys.exit(main())
