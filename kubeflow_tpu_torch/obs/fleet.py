"""The span-export half of ``kubeflow_tpu/obs/fleet.py``: the per-process
drain payload each HTTP surface serves, and its paths. Stitching spans
across processes and the collector that drains them belong to the control
plane, which the port does not have yet.
"""

from __future__ import annotations

import os
import time
from typing import Optional

from kubeflow_tpu_torch.obs.trace import get_tracer

#: Drain endpoints (the span-export twins of ``/debug/traces``).
SPANS_EXPORT_PATH = "/debug/spans/export"
ROUTER_SPANS_EXPORT_PATH = "/-/router/debug/spans/export"


def spans_export_payload(tracer=None, *, process: Optional[str] = None,
                         limit: int = 128) -> dict:
    """The ``/debug/spans/export`` response body: every completed span in
    this process's tracer ring (open spans export on a later drain), the
    process identity and the export-time wall clock (``now``, which a
    collector brackets with its own clock to estimate this process's
    offset). Export reads the ring, so repeated drains re-send the same
    spans; a collector dedups by span id."""
    t = tracer or get_tracer()
    spans: list[dict] = []
    for rec in t.traces(limit=limit):
        spans.extend(rec["spans"])
    return {
        "process": {"name": process or f"pid:{os.getpid()}",
                    "pid": os.getpid()},
        "now": time.time(),
        "spans": spans,
    }
