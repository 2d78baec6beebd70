"""The quantile helpers of ``kubeflow_tpu/obs/stats.py`` (a copy): the
linear-interpolation definition (numpy's default, exact at the
boundaries), so a p95 the port reports is the same statistic as the JAX
package's, and the millisecond summary the loadgen's reports print. Pure
stdlib."""

from __future__ import annotations

import math
from typing import Iterable, Sequence


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


def quantiles_ms(xs: Sequence[float],
                 qs: Iterable[float] = (0.5, 0.95, 0.99)) -> dict:
    """Seconds → milliseconds percentile summary: ``{"p50": ..., "p95":
    ..., "p99": ...}`` (keys from ``qs``), rounded to 0.1 ms. Empty input
    returns {} — absent beats fabricated."""
    if not xs:
        return {}
    s = sorted(xs)
    return {_plabel(q): round(quantile(s, q) * 1e3, 1) for q in qs}


def _plabel(q: float) -> str:
    # 0.95 → "p95", 0.999 → "p99.9" (float-noise-proof: 0.95*100 is
    # 94.99999... in binary).
    return f"p{round(q * 100, 4):g}"
