"""The quantile helper of ``kubeflow_tpu/obs/stats.py`` (a copy): the
linear-interpolation definition (numpy's default, exact at the
boundaries), so a p95 the port reports is the same statistic as the JAX
package's. Pure stdlib."""

from __future__ import annotations

import math
from typing import Sequence


def quantile(xs: Sequence[float], q: float) -> float:
    """Linear-interpolation quantile of ``xs`` (numpy's default method).

    ``q`` in [0, 1]. Exact at the boundaries: ``quantile(xs, 0)`` is the
    minimum, ``quantile(xs, 1)`` the maximum, and for a sorted odd-length
    list ``quantile(xs, 0.5)`` is the exact middle element. Raises on an
    empty sequence (a silent 0.0 would read as a perfect latency)."""
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"quantile q must be in [0, 1], got {q}")
    s = sorted(xs)
    if not s:
        raise ValueError("quantile of empty sequence")
    pos = q * (len(s) - 1)
    lo = math.floor(pos)
    hi = math.ceil(pos)
    if lo == hi:
        return float(s[lo])
    frac = pos - lo
    return float(s[lo]) * (1.0 - frac) + float(s[hi]) * frac
