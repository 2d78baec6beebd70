"""Request tracing: one trace id from the model server to the decode step
(the surface of ``kubeflow_tpu/obs/trace.py`` the port's engine, server and
router use, copied: spans, cross-thread parents, header propagation, a
bounded ring of recent traces with its read surfaces — ``traces``, the
Chrome trace-event export and the shared ``/debug/traces`` payload — and
the per-phase rollup ``phase_durations`` the loadgen's reports read).

The server joins the ``X-Kftpu-Trace`` header and spans the request; the
engine scheduler spans each request's queued → prefill → decode lifecycle
(decode rounds land as span events). Contextvars do not flow into the
scheduler thread, so the server attaches its span's context to the engine
``Request`` and the scheduler opens children against that explicit parent.
"""

from __future__ import annotations

import contextlib
import contextvars
import os
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, Iterator, Optional

#: Span-event cap: decode annotates one event per round, and a long
#: generation must not grow an unbounded list.
MAX_EVENTS = 32


def _new_id(nbytes: int) -> str:
    return os.urandom(nbytes).hex()


@dataclass(frozen=True)
class SpanContext:
    """The propagatable identity of a span (what rides in the header)."""

    trace_id: str
    span_id: str

    def header_value(self) -> str:
        return f"{self.trace_id}-{self.span_id}"


def parse_trace_header(value: Optional[str]) -> Optional[SpanContext]:
    """``<trace_id>-<span_id>`` → SpanContext, or None on absent/garbage
    (a malformed header must start a fresh trace, never 500 a request)."""
    if not value:
        return None
    trace_id, sep, span_id = value.strip().partition("-")
    if not sep or not trace_id or not span_id:
        return None
    if not all(c in "0123456789abcdef" for c in trace_id + span_id):
        return None
    return SpanContext(trace_id=trace_id, span_id=span_id)


class Span:
    """One timed operation; single-writer by convention until ``end()``."""

    __slots__ = ("_tracer", "trace_id", "span_id", "parent_id", "name",
                 "start", "end_time", "attrs", "events", "status")

    def __init__(self, tracer: "Tracer", name: str, trace_id: str,
                 parent_id: Optional[str], attrs: dict):
        self._tracer = tracer
        self.trace_id = trace_id
        self.span_id = _new_id(8)
        self.parent_id = parent_id
        self.name = name
        self.start = time.time()
        self.end_time: Optional[float] = None
        self.attrs = attrs
        self.events: list[dict] = []
        self.status = "ok"

    @property
    def context(self) -> SpanContext:
        return SpanContext(trace_id=self.trace_id, span_id=self.span_id)

    @property
    def duration(self) -> Optional[float]:
        if self.end_time is None:
            return None
        return self.end_time - self.start

    def set_attrs(self, **attrs: Any) -> "Span":
        self.attrs.update(attrs)
        return self

    def add_event(self, name: str, **attrs: Any) -> None:
        if len(self.events) >= MAX_EVENTS:
            return
        self.events.append({"name": name, "ts": time.time(), **attrs})

    def end(self, status: Optional[str] = None) -> None:
        """Idempotent close; the first call wins."""
        if self.end_time is not None:
            return
        if status is not None:
            self.status = status
        self.end_time = time.time()
        self._tracer._on_end(self)

    def to_dict(self) -> dict:
        return {
            "trace_id": self.trace_id, "span_id": self.span_id,
            "parent_id": self.parent_id, "name": self.name,
            "start": self.start, "end": self.end_time,
            "duration_ms": (None if self.duration is None
                            else self.duration * 1e3),
            "status": self.status, "attrs": dict(self.attrs),
            "events": list(self.events),
        }


class Tracer:
    """Thread-safe span tracer with an in-memory ring of recent traces.
    ``span()`` nests through a contextvar within a thread;
    ``start_span(parent=...)`` is the cross-thread path."""

    def __init__(self, max_traces: int = 256):
        self._max_traces = max_traces
        self._lock = threading.Lock()
        self._traces: "OrderedDict[str, dict]" = OrderedDict()  # guarded_by: _lock
        self._open = 0                                           # guarded_by: _lock
        self._current: contextvars.ContextVar[Optional[Span]] = \
            contextvars.ContextVar("kftpu_torch_current_span", default=None)

    def start_span(self, name: str,
                   parent: Optional[SpanContext | Span] = None, *,
                   start: Optional[float] = None, **attrs: Any) -> Span:
        """Open a span without touching the contextvar; ``parent`` may be a
        Span, a SpanContext, or None for a new root. ``start`` (epoch
        seconds) back-dates a retrospective span."""
        if parent is None:
            trace_id, parent_id = _new_id(16), None
        else:
            trace_id, parent_id = parent.trace_id, parent.span_id
        span = Span(self, name, trace_id, parent_id, attrs)
        if start is not None:
            span.start = start
        with self._lock:
            self._open += 1
            if trace_id not in self._traces:
                self._traces[trace_id] = {"spans": [], "root": None,
                                          "open": 0}
                while len(self._traces) > self._max_traces:
                    self._traces.popitem(last=False)
            self._traces[trace_id]["open"] += 1
        return span

    @contextlib.contextmanager
    def span(self, name: str, parent: Optional[SpanContext | Span] = None,
             **attrs: Any) -> Iterator[Span]:
        """Contextvar-propagated span; an escaping exception closes it with
        ``error`` status and its type attached."""
        sp = self.start_span(name, parent=parent or self._current.get(),
                             **attrs)
        token = self._current.set(sp)
        try:
            yield sp
        except BaseException as exc:
            sp.set_attrs(error=f"{type(exc).__name__}: {exc}")
            sp.end("error")
            raise
        finally:
            self._current.reset(token)
            sp.end()

    def current(self) -> Optional[Span]:
        return self._current.get()

    def inject(self, span: Optional[Span]) -> Optional[str]:
        """Header value carrying ``span``'s context (None when untraced)."""
        if span is None:
            return None
        return span.context.header_value()

    def extract(self, header_value: Optional[str]) -> Optional[SpanContext]:
        return parse_trace_header(header_value)

    def _on_end(self, span: Span) -> None:
        d = span.to_dict()
        with self._lock:
            self._open -= 1
            rec = self._traces.get(span.trace_id)
            if rec is not None:        # may have been evicted while open
                rec["open"] -= 1
                rec["spans"].append(d)
                if span.parent_id is None:
                    rec["root"] = d

    def open_spans(self, trace_id: Optional[str] = None) -> int:
        """Started-but-not-ended spans (an idle stack holds zero); with
        ``trace_id``, those of that one trace."""
        with self._lock:
            if trace_id is None:
                return self._open
            rec = self._traces.get(trace_id)
            return 0 if rec is None else rec["open"]

    def traces(self, slowest: Optional[int] = None,
               limit: int = 64) -> list[dict]:
        """Recent traces, newest first (or the N slowest by root duration
        when ``slowest`` is given). Each entry: trace_id, root span and the
        full span list."""
        with self._lock:
            items = [
                {"trace_id": tid,
                 "root": rec["root"],
                 "spans": list(rec["spans"])}
                for tid, rec in self._traces.items()
            ]
        items.reverse()
        if slowest is not None:
            items = [t for t in items if t["root"] is not None]
            items.sort(key=lambda t: t["root"]["duration_ms"] or 0.0,
                       reverse=True)
            items = items[:max(slowest, 0)]
        else:
            items = items[:limit]
        return items

    def trace(self, trace_id: str) -> Optional[dict]:
        with self._lock:
            rec = self._traces.get(trace_id)
            if rec is None:
                return None
            return {"trace_id": trace_id, "root": rec["root"],
                    "spans": list(rec["spans"])}

    def export_chrome(self, trace_id: Optional[str] = None) -> dict:
        """Chrome trace-event JSON (``about:tracing`` / Perfetto): complete
        "X" events, microsecond timestamps, one pid per process and the
        span id folded into tid so sibling spans stack visibly; span events
        are thread-scoped instants on their span's lane."""
        selected = ([self.trace(trace_id)] if trace_id is not None
                    else self.traces())
        events = []
        for t in selected:
            if not t:
                continue
            for s in t["spans"]:
                if s["end"] is None:
                    continue
                events.append({
                    "name": s["name"], "cat": "kftpu", "ph": "X",
                    "ts": s["start"] * 1e6,
                    "dur": (s["end"] - s["start"]) * 1e6,
                    "pid": os.getpid(),
                    "tid": int(s["span_id"][:6], 16),
                    "args": {**s["attrs"], "trace_id": s["trace_id"],
                             "status": s["status"]},
                })
                for ev in s.get("events", []):
                    events.append({
                        "name": ev["name"], "cat": "kftpu", "ph": "i",
                        "ts": ev["ts"] * 1e6, "s": "t",
                        "pid": os.getpid(),
                        "tid": int(s["span_id"][:6], 16),
                        "args": {k: v for k, v in ev.items()
                                 if k not in ("name", "ts")},
                    })
        return {"traceEvents": events, "displayTimeUnit": "ms"}


#: Engine lifecycle phases, in order (the ``engine.<phase>`` span names).
ENGINE_PHASES = ("queued", "adapter_load", "kv_migrate", "prefill",
                 "handoff", "decode")


def phase_durations(spans: list[dict]) -> dict:
    """Total engine time per lifecycle phase in a span list, in ms:
    ``{"queued_ms": ..., "prefill_ms": ..., "decode_ms": ...}``.

    Sums every closed ``engine.<phase>`` span — a preempted request
    contributes two queued (and prefill) spans, and the sum is the real
    time it spent in that phase. Phases with no closed span are absent;
    a trace with no engine spans returns {}. The loadgen's attribution
    reports aggregate this per-request breakdown."""
    out: dict = {}
    for s in spans:
        name = s.get("name", "")
        if not name.startswith("engine."):
            continue
        phase = name.split(".", 1)[1]
        if phase not in ENGINE_PHASES or s.get("duration_ms") is None:
            continue
        key = f"{phase}_ms"
        out[key] = round(out.get(key, 0.0) + s["duration_ms"], 3)
    return out


def debug_traces_payload(path: str,
                         tracer: Optional[Tracer] = None) -> dict:
    """The shared ``/debug/traces`` response body: recent traces as JSON,
    ``?slowest=N`` for the N slowest by root duration, ``?chrome=1`` for a
    Chrome trace-event export. Traces touching the engine carry a
    ``phases`` rollup (queued/prefill/decode ms)."""
    from urllib.parse import parse_qs, urlparse

    t = tracer or get_tracer()
    q = parse_qs(urlparse(path).query)
    if q.get("chrome", ["0"])[0] not in ("0", "", "false"):
        return t.export_chrome()
    slowest_raw = q.get("slowest", [None])[0]
    try:
        slowest = int(slowest_raw) if slowest_raw is not None else None
    except ValueError:
        slowest = None
    traces = t.traces(slowest=slowest)
    for tr in traces:
        phases = phase_durations(tr["spans"])
        if phases:
            tr["phases"] = phases
    return {"traces": traces}


#: The process-wide tracer every layer shares.
_TRACER = Tracer()


def get_tracer() -> Tracer:
    return _TRACER
