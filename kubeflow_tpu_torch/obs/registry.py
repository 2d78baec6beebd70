"""Prometheus-exposition metrics registry (a copy of
``kubeflow_tpu/obs/registry.py`` without the runtime contract auditor).

One Counter/Gauge/Histogram implementation and one ``render()`` path: label
escaping, histogram rendering (cumulative ``_bucket`` series with the
``+Inf`` tail, ``_sum``/``_count``), and ``parse_exposition()``, the
strict grammar check the tests use. Endpoints
build a fresh registry per scrape from their live counters.
"""

from __future__ import annotations

import math
import re
import threading
from typing import Any, Iterable, Optional

METRIC_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
LABEL_NAME_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")


def escape_label_value(value: Any) -> str:
    """Exposition-format label-value escaping: backslash first (or the
    other escapes' backslashes would double-escape), then quote, then
    newline — quotes/backslashes/newlines in object names previously
    emitted invalid exposition text."""
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _fmt_value(value: Any) -> str:
    if value == float("inf"):
        return "+Inf"
    if value == float("-inf"):
        return "-Inf"
    return repr(value) if isinstance(value, float) else str(value)


def format_line(name: str, value: Any,
                labels: Optional[dict] = None) -> str:
    """One exposition sample line with escaped label values."""
    if labels:
        lab = ",".join(f'{k}="{escape_label_value(v)}"'
                       for k, v in sorted(labels.items()))
        return f"{name}{{{lab}}} {_fmt_value(value)}"
    return f"{name} {_fmt_value(value)}"


class Metric:
    """Base: a named family holding one sample per label set (insertion
    order preserved for stable scrape output)."""

    mtype = "untyped"

    def __init__(self, name: str, help: str = ""):
        if not METRIC_NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._samples: dict[tuple, float] = {}  # guarded_by: _lock

    @staticmethod
    def _key(labels: dict) -> tuple:
        for k in labels:
            if not LABEL_NAME_RE.match(k):
                raise ValueError(f"invalid label name {k!r}")
        return tuple(sorted(labels.items()))

    def _set(self, value: float, labels: dict) -> None:
        with self._lock:
            self._samples[self._key(labels)] = value

    def render(self) -> list[str]:
        out = [f"# TYPE {self.name} {self.mtype}"]
        if self.help:
            out.insert(0, f"# HELP {self.name} {self.help}")
        with self._lock:
            for key, value in self._samples.items():
                out.append(format_line(self.name, value, dict(key)))
        return out


class Counter(Metric):
    mtype = "counter"

    def inc(self, amount: float = 1, **labels: Any) -> None:
        if amount < 0:
            raise ValueError("counters only go up")
        with self._lock:
            key = self._key(labels)
            self._samples[key] = self._samples.get(key, 0) + amount


class Gauge(Metric):
    mtype = "gauge"

    def set(self, value: float, **labels: Any) -> None:
        self._set(value, labels)


class Histogram(Metric):
    """Prometheus histogram whose per-bucket counts are kept elsewhere and
    adopted with ``set_cumulative()`` (the engine keeps its queue-delay and
    host-gap counters on the hot path)."""

    mtype = "histogram"

    def __init__(self, name: str, buckets: Iterable[float], help: str = ""):
        super().__init__(name, help)
        self.buckets = [float(b) for b in buckets]
        if self.buckets != sorted(self.buckets):
            raise ValueError(f"{name}: buckets must be sorted")
        # label key -> {"counts": [per-bucket + +Inf], "sum": s, "n": n}
        self._hists: dict[tuple, dict] = {}     # guarded_by: _lock

    def set_cumulative(self, counts: list[int], total_sum: float, n: int,
                       **labels: Any) -> None:
        if len(counts) != len(self.buckets) + 1:
            raise ValueError(
                f"{self.name}: need {len(self.buckets) + 1} bucket counts "
                f"(incl. +Inf tail), got {len(counts)}")
        with self._lock:
            self._hists[self._key(labels)] = {
                "counts": list(counts), "sum": total_sum, "n": n}

    def render(self) -> list[str]:
        out = [f"# TYPE {self.name} {self.mtype}"]
        if self.help:
            out.insert(0, f"# HELP {self.name} {self.help}")
        with self._lock:
            for key, h in self._hists.items():
                labels = dict(key)
                acc = 0
                for le, c in zip(self.buckets + [float("inf")], h["counts"]):
                    acc += c
                    out.append(format_line(
                        self.name + "_bucket", acc,
                        {**labels, "le": "+Inf" if le == float("inf")
                         else le}))
                out.append(format_line(self.name + "_sum", h["sum"], labels))
                out.append(format_line(self.name + "_count", h["n"], labels))
        return out


class MetricsRegistry:
    """Named metric families with one shared exposition path."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[str, Metric] = {}   # guarded_by: _lock

    def _get_or_make(self, cls, name: str, help: str = "", **kw) -> Metric:
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if type(existing) is not cls:
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{existing.mtype}")
                return existing
            metric = cls(name, help=help, **kw)
            self._metrics[name] = metric
            return metric

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_make(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_make(Gauge, name, help)

    def histogram(self, name: str, buckets: Iterable[float],
                  help: str = "") -> Histogram:
        return self._get_or_make(Histogram, name, help, buckets=buckets)

    def names(self) -> list[str]:
        with self._lock:
            return list(self._metrics)

    def render(self) -> str:
        with self._lock:
            metrics = list(self._metrics.values())
        lines: list[str] = []
        for m in metrics:
            lines.extend(m.render())
        return "\n".join(lines) + "\n"


# -- exposition grammar checking ----------------------------------------------

_LABEL_RE = (r'[a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\\n]|\\\\|\\"|\\n)*"')
_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>" + _LABEL_RE + r"(?:," + _LABEL_RE + r")*)?\})?"
    r" (?P<value>[+-]?(?:Inf|NaN|[0-9.eE+-]+))$")
_COMMENT_RE = re.compile(r"^# (?:TYPE|HELP) [a-zA-Z_:][a-zA-Z0-9_:]* .+$")


def _unescape(value: str) -> str:
    return (value.replace("\\n", "\n").replace('\\"', '"')
            .replace("\\\\", "\\"))


def parse_exposition(text: str) -> list[tuple[str, dict, float]]:
    """Strict line-by-line parse of exposition text. Returns
    ``(series_name, labels, value)`` per sample; raises ``ValueError``
    naming the first offending line — the shared "does /metrics parse"
    check for tests and the obs smoke stage."""
    samples: list[tuple[str, dict, float]] = []
    for i, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        if line.startswith("#"):
            if not _COMMENT_RE.match(line):
                raise ValueError(f"line {i}: bad comment line {line!r}")
            continue
        m = _SAMPLE_RE.match(line)
        if not m:
            raise ValueError(f"line {i}: bad sample line {line!r}")
        labels: dict[str, str] = {}
        if m.group("labels"):
            for part in re.finditer(_LABEL_RE, m.group("labels")):
                k, _, v = part.group(0).partition("=")
                labels[k] = _unescape(v[1:-1])
        v = m.group("value")
        value = (math.inf if v in ("Inf", "+Inf")
                 else -math.inf if v == "-Inf"
                 else math.nan if v == "NaN" else float(v))
        samples.append((m.group("name"), labels, value))
    return samples
