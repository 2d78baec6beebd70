"""Model server: the HTTP protocol surface over one port LLM engine (port of
``kubeflow_tpu/serve/server.py``, single-engine routes).

Routes:

- ``GET /healthz``, ``/v2/health/ready``, ``/v2/health/live``;
  ``GET /v1/models``; ``GET /v2/models/{name}`` (metadata);
  ``GET /metrics`` (Prometheus text, the same series names as the JAX
  package's ``serving_metrics_registry``);
- ``POST /v1/completions`` (OpenAI-compatible; ``stream=true`` → SSE);
- ``POST /v1/models/{name}:predict`` (v1 protocol);
- ``POST /v2/models/{name}/infer`` (v2 open-inference protocol).

Chat completions, explain, the KV handoff relay, the model repository and
gRPC arrive with later slices (404 here). Threaded stdlib server: handlers
block on the engine's request stream; the engine thread batches.
"""

from __future__ import annotations

import json
import queue
import re
import sys
import threading
import time
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Optional

from kubeflow_tpu_torch.core.headers import (
    DEADLINE_HEADER, MODEL_HEADER, QOS_HEADER, TRACE_HEADER,
)
from kubeflow_tpu_torch.core.serving import QOS_DEFAULT
from kubeflow_tpu_torch.obs.registry import MetricsRegistry
from kubeflow_tpu_torch.obs.trace import get_tracer
from kubeflow_tpu_torch.serve.engine import (
    EngineOverloaded, HOST_GAP_BUCKETS, LLMEngine, QUEUE_DELAY_BUCKETS,
    Request, SamplingParams,
)
from kubeflow_tpu_torch.serve.tokenizer import Tokenizer, get_tokenizer


def _raise_for_reaped(req: Request) -> None:
    """Map an engine-side terminal failure to the exception the protocol
    layer turns into an explicit HTTP status (504/429/500): a reaped request
    must never be served as a successful (empty) completion."""
    if req.finish_reason in ("deadline", "cancelled"):
        raise TimeoutError(
            f"request {req.id} {req.finish_reason} before completion")
    if req.finish_reason == "shed":
        raise EngineOverloaded(
            f"request {req.id} shed: queue delay exceeded budget")
    if req.finish_reason == "error":
        raise RuntimeError(f"request {req.id} failed in-engine")


def _quiet_handle_error(httpd) -> None:
    """Client hang-ups mid-response are routine under load shedding, not a
    traceback worth printing; anything else still prints."""

    def handle_error(request, client_address):
        exc = sys.exc_info()[1]
        if isinstance(exc, (ConnectionError, TimeoutError)):
            return
        traceback.print_exc()

    httpd.handle_error = handle_error


_V1_PREDICT = re.compile(r"^/v1/models/([^/:]+):predict$")
_V2_MODEL = re.compile(r"^/v2/models/([^/]+)$")
_V2_INFER = re.compile(r"^/v2/models/([^/]+)/infer$")


class ModelServer:
    def __init__(self, name: str, engine: LLMEngine, *,
                 tokenizer: Optional[Tokenizer] = None,
                 host: str = "127.0.0.1", port: int = 0):
        self.name = name
        self.engine = engine
        self.tokenizer = tokenizer or get_tokenizer("byte")
        self._in_flight = 0             # guarded_by: _in_flight_lock
        self._in_flight_lock = threading.Lock()
        self.httpd = ThreadingHTTPServer((host, port), _make_handler(self))
        self.httpd.daemon_threads = True
        _quiet_handle_error(self.httpd)
        self.port = self.httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle -------------------------------------------------------------

    def start(self) -> None:
        self.engine.start()
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True, name="model-server")
        self._thread.start()

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        self.engine.stop()

    @property
    def url(self) -> str:
        return f"http://127.0.0.1:{self.port}"

    # -- model resolution ------------------------------------------------------

    def model_names(self) -> list[str]:
        return [self.name]

    def check_model(self, name: Optional[str], *, strict: bool) -> None:
        """``strict`` (path-addressed endpoints): a foreign name is a 404.
        Non-strict (the OpenAI body "model" field) ignores it — OpenAI SDK
        clients always send one."""
        if strict and name not in (None, self.name):
            raise KeyError(f"unknown model {name!r} (serving {self.name})")

    def request_timeout(self, body: dict,
                        deadline_s: Optional[float] = None) -> float:
        """The body ``timeout`` capped by the remaining client budget from
        the deadline header."""
        timeout = float(body.get("timeout", 300))
        if deadline_s is not None:
            timeout = min(timeout, max(deadline_s, 0.0))
        return timeout

    def submit_text(self, prompt: str, body: dict, *,
                    deadline_s: Optional[float], qos: str) -> tuple:
        """Tokenize and submit; returns (request, timeout). The engine-side
        deadline equals the client budget, so the scheduler reaps the
        request the moment the client can no longer use the answer."""
        timeout = self.request_timeout(body, deadline_s)
        toks = self.tokenizer.encode(prompt)
        req = self.engine.submit(toks, self.sampling_from(body, self.tokenizer),
                                 deadline=time.monotonic() + timeout,
                                 trace_parent=get_tracer().current(), qos=qos)
        return req, timeout

    def generate_text(self, prompt: str, body: dict, model: Optional[str],
                      strict: bool = False,
                      deadline_s: Optional[float] = None,
                      qos: str = QOS_DEFAULT) -> tuple[str, Request]:
        """Tokenize → engine → detokenize: the generation path every route
        shares."""
        self.check_model(model, strict=strict)
        req, timeout = self.submit_text(prompt, body, deadline_s=deadline_s,
                                        qos=qos)
        try:
            out = req.result(timeout=timeout + 1.0)
        except TimeoutError:
            req.cancel()
            raise
        _raise_for_reaped(req)
        with get_tracer().span("server.detokenize", tokens=len(out)):
            text = self.tokenizer.decode(
                [t for t in out if t != self.tokenizer.eos_id])
        return text, req

    # -- request plumbing ------------------------------------------------------

    def track(self, delta: int) -> None:
        with self._in_flight_lock:
            self._in_flight += delta

    @property
    def in_flight(self) -> int:
        with self._in_flight_lock:
            return self._in_flight

    @staticmethod
    def sampling_from(body: dict[str, Any],
                      tokenizer: Tokenizer) -> SamplingParams:
        return SamplingParams(
            max_new_tokens=int(body.get("max_tokens", 64)),
            temperature=float(body.get("temperature", 0.0)),
            top_k=int(body.get("top_k", 0)),
            top_p=float(body.get("top_p", 1.0)),
            stop_token=tokenizer.eos_id,
        )

    def metrics_text(self) -> str:
        return serving_metrics_registry(
            [(self.name, self.engine)], in_flight=self.in_flight).render()


def serving_metrics_registry(engines: list, *,
                             in_flight: int = 0) -> MetricsRegistry:
    """The serving ``/metrics`` registry for ``(name, engine)`` pairs — the
    same ``kftpu_serving_*`` / ``kftpu_engine_*`` series the JAX package's
    model server exposes, so loadgen, router and autoscaler scrapes read a
    port replica unchanged (series a contiguous-cache engine has no source
    for render 0)."""
    reg = MetricsRegistry()
    requests_total = reg.counter("kftpu_serving_requests_total")
    tokens_total = reg.counter("kftpu_serving_tokens_total")
    reg.gauge("kftpu_serving_in_flight").set(in_flight)
    queue_depth = reg.gauge("kftpu_serving_queue_depth")
    shed = reg.counter("kftpu_serving_requests_shed_total")
    cancelled = reg.counter("kftpu_serving_requests_cancelled_total")
    expired = reg.counter("kftpu_serving_requests_expired_total")
    qdelay = reg.histogram("kftpu_serving_queue_delay_seconds",
                           QUEUE_DELAY_BUCKETS)
    preempt = reg.counter("kftpu_serving_preemptions_total")
    qos_requests = reg.counter("kftpu_serving_qos_requests_total")
    qos_shed = reg.counter("kftpu_serving_qos_requests_shed_total")
    qos_preempt = reg.counter("kftpu_serving_qos_preemptions_total")
    qos_ttft = reg.gauge("kftpu_serving_qos_ttft_p95_ms")
    qos_qd = reg.gauge("kftpu_serving_qos_queue_delay_p95_ms")
    qos_qdelay = reg.histogram("kftpu_serving_qos_queue_delay_seconds",
                               QUEUE_DELAY_BUCKETS)
    host_gap = reg.histogram("kftpu_engine_host_gap_seconds",
                             HOST_GAP_BUCKETS)
    depth = reg.gauge("kftpu_engine_dispatch_depth")
    pending_prefill = reg.gauge("kftpu_engine_pending_prefill_tokens")
    pages_resident = reg.gauge("kftpu_engine_kv_pages_resident")
    pages_cached = reg.gauge("kftpu_engine_kv_pages_cached")
    pages_host = reg.gauge("kftpu_engine_kv_pages_host")
    prefix_hits = reg.counter("kftpu_engine_kv_prefix_hits_total")
    prefix_tokens = reg.counter("kftpu_engine_kv_prefix_tokens_reused_total")
    cow_copies = reg.counter("kftpu_engine_kv_cow_copies_total")
    pages_demoted = reg.counter("kftpu_engine_kv_pages_demoted_total")
    pages_promoted = reg.counter("kftpu_engine_kv_pages_promoted_total")
    handoffs_out = reg.counter("kftpu_engine_handoffs_exported_total")
    handoffs_in = reg.counter("kftpu_engine_handoffs_adopted_total")
    handoffs_bad = reg.counter("kftpu_engine_handoffs_failed_total")
    pages_remote = reg.gauge("kftpu_engine_kv_pages_remote")
    remote_demote_b = reg.counter(
        "kftpu_engine_kv_remote_demoted_bytes_total")
    remote_promote_b = reg.counter(
        "kftpu_engine_kv_remote_promoted_bytes_total")
    remote_timeouts = reg.counter(
        "kftpu_engine_kv_remote_promote_timeouts_total")
    remote_corrupt = reg.counter(
        "kftpu_engine_kv_remote_blobs_corrupt_total")
    tier_pressure = reg.gauge("kftpu_engine_kv_tier_pressure")
    handoffs_retried = reg.counter("kftpu_engine_handoffs_retried_total")
    handoffs_fb = reg.counter("kftpu_engine_handoffs_fallback_total")
    kvq_enabled = reg.gauge("kftpu_engine_kv_quant_enabled")
    kvq_density = reg.gauge("kftpu_engine_kv_quant_tokens_per_mib")
    ho_bytes_out = reg.counter("kftpu_engine_kv_handoff_bytes_exported_total")
    ho_bytes_in = reg.counter("kftpu_engine_kv_handoff_bytes_adopted_total")
    wire_demote = reg.counter("kftpu_engine_kv_wire_bytes_demoted_total")
    wire_promote = reg.counter("kftpu_engine_kv_wire_bytes_promoted_total")
    adapters_resident = reg.gauge("kftpu_engine_adapters_resident")
    adapter_loads = reg.counter("kftpu_engine_adapter_loads_total")
    adapter_evictions = reg.counter("kftpu_engine_adapter_evictions_total")
    for name, engine in engines:
        snap = engine.metrics.snapshot()
        requests_total.inc(snap["requests_completed"], model=name)
        tokens_total.inc(snap["tokens_generated"], model=name)
        for k in ("ttft_p50_ms", "ttft_p95_ms", "ttft_p99_ms",
                  "tpot_p50_ms", "queue_delay_p95_ms",
                  "requests_per_sec", "tokens_per_sec",
                  "spec_acceptance_rate", "spec_tokens_per_step",
                  "spec_draft_overhead", "host_gap_p50_ms",
                  "host_gap_p99_ms"):
            if k in snap:
                reg.gauge(f"kftpu_serving_{k}").set(snap[k], model=name)
        queue_depth.set(engine.queue_depth(), model=name)
        shed.inc(snap["requests_shed"], model=name)
        cancelled.inc(snap["requests_cancelled"], model=name)
        expired.inc(snap["requests_expired"], model=name)
        _, counts, qsum, qn = engine.metrics.queue_delay_histogram()
        qdelay.set_cumulative(counts, qsum, qn, model=name)
        preempt.inc(snap.get("preemptions", 0), model=name)
        for cls, c in snap.get("qos", {}).items():
            qos_requests.inc(c["completed"], model=name, qos=cls)
            qos_shed.inc(c["shed"], model=name, qos=cls)
            qos_preempt.inc(c["preempted"], model=name, qos=cls)
            if "ttft_p95_ms" in c:
                qos_ttft.set(c["ttft_p95_ms"], model=name, qos=cls)
            if "queue_delay_p95_ms" in c:
                qos_qd.set(c["queue_delay_p95_ms"], model=name, qos=cls)
            _, ccounts, csum, cn = \
                engine.metrics.queue_delay_histogram(cls)
            qos_qdelay.set_cumulative(ccounts, csum, cn,
                                      model=name, qos=cls)
        _, hcounts, hsum, hn = engine.metrics.host_gap_histogram()
        host_gap.set_cumulative(hcounts, hsum, hn, model=name)
        depth.set(snap.get("dispatch_depth", 0), model=name)
        pending_prefill.set(engine.pending_prefill_tokens(), model=name)
        pages_resident.set(engine.kv_pages_in_use(), model=name)
        pages_cached.set(engine.kv_pages_cached(), model=name)
        pages_host.set(engine.kv_pages_host(), model=name)
        tier = engine.kv_tier_stats()
        prefix_hits.inc(tier.get("prefix_hits", 0), model=name)
        prefix_tokens.inc(tier.get("tokens_matched", 0), model=name)
        cow_copies.inc(tier.get("cow_copies", 0), model=name)
        pages_demoted.inc(tier.get("pages_demoted", 0), model=name)
        pages_promoted.inc(tier.get("pages_promoted", 0), model=name)
        handoffs_out.inc(snap.get("handoffs_exported", 0), model=name)
        handoffs_in.inc(snap.get("handoffs_adopted", 0), model=name)
        handoffs_bad.inc(snap.get("handoffs_failed", 0), model=name)
        handoffs_retried.inc(snap.get("handoffs_retried", 0), model=name)
        handoffs_fb.inc(snap.get("handoffs_fallback", 0), model=name)
        pages_remote.set(engine.kv_pages_remote(), model=name)
        remote_demote_b.inc(tier.get("remote_demote_bytes", 0), model=name)
        remote_promote_b.inc(tier.get("remote_promote_bytes", 0),
                             model=name)
        remote_timeouts.inc(tier.get("remote_promote_timeouts", 0),
                            model=name)
        remote_corrupt.inc(tier.get("remote_blobs_corrupt", 0), model=name)
        tier_pressure.set(round(engine.kv_tier_pressure(), 3), model=name)
        density = engine.kv_pool_density()
        kvq_enabled.set(density.get("quant", 0), model=name)
        kvq_density.set(round(density.get("tokens_per_mib", 0.0), 1),
                        model=name)
        ho_bytes_out.inc(snap.get("handoff_bytes_exported", 0), model=name)
        ho_bytes_in.inc(snap.get("handoff_bytes_adopted", 0), model=name)
        wire_demote.inc(tier.get("demote_wire_bytes", 0), model=name)
        wire_promote.inc(tier.get("promote_wire_bytes", 0), model=name)
        resident = engine.adapters_resident()
        for a in resident:
            adapters_resident.set(1, model=name, adapter=a)
        if not resident:
            adapters_resident.set(0, model=name)
        astats = engine.adapter_stats()
        adapter_loads.inc(astats.get("loads", 0), model=name)
        adapter_evictions.inc(astats.get("evictions", 0), model=name)
    return reg


def _make_handler(server: ModelServer):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, *args) -> None:  # quiet
            pass

        # -- helpers ----------------------------------------------------------

        def _json(self, code: int, obj: Any,
                  headers: Optional[dict] = None) -> None:
            data = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(data)

        def _text(self, code: int, text: str, ctype="text/plain") -> None:
            data = text.encode()
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def _body(self) -> dict:
            n = int(self.headers.get("Content-Length", 0))
            return json.loads(self.rfile.read(n) or b"{}")

        def _deadline_s(self) -> Optional[float]:
            """Remaining client budget (seconds) from the deadline header."""
            hdr = self.headers.get(DEADLINE_HEADER)
            if not hdr:
                return None
            try:
                return max(float(hdr) / 1e3, 0.0)
            except ValueError:
                return None

        def _qos(self, body: dict) -> str:
            raw = self.headers.get(QOS_HEADER) or body.get("qos") \
                or QOS_DEFAULT
            return str(raw).strip().lower()

        # -- GET ---------------------------------------------------------------

        def do_GET(self) -> None:
            if self.path in ("/healthz", "/v2/health/ready", "/v2/health/live"):
                return self._json(200, {"status": "ok", "name": server.name})
            if self.path == "/metrics":
                return self._text(200, server.metrics_text())
            if self.path == "/v1/models":
                return self._json(200, {"models": server.model_names()})
            m = _V2_MODEL.match(self.path)
            if m and m.group(1) == server.name:
                cfg = server.engine.cfg
                return self._json(200, {
                    "name": m.group(1),
                    "platform": "kubeflow-tpu-torch-llm",
                    "inputs": [{"name": "text", "datatype": "BYTES",
                                "shape": [-1]}],
                    "outputs": [{"name": "text", "datatype": "BYTES",
                                 "shape": [-1]}],
                    "config": {"vocab_size": cfg.vocab_size,
                               "max_seq_len": cfg.max_seq_len},
                })
            if m:
                return self._json(404, {"error": f"no model {m.group(1)}"})
            self._json(404, {"error": f"not found: {self.path}"})

        # -- POST --------------------------------------------------------------

        def do_POST(self) -> None:
            server.track(1)
            tracer = get_tracer()
            try:
                with tracer.span(
                        "server.request",
                        parent=tracer.extract(self.headers.get(TRACE_HEADER)),
                        path=self.path, server=server.name):
                    # Drain the body first: keep-alive breaks on unread bytes.
                    body = self._body()
                    m = _V1_PREDICT.match(self.path)
                    if m:
                        return self._v1_predict(body, m.group(1))
                    m = _V2_INFER.match(self.path)
                    if m:
                        return self._v2_infer(body, m.group(1))
                    if self.path == "/v1/completions":
                        return self._completions(body)
                    self._json(404, {"error": f"not found: {self.path}"})
            except KeyError as exc:
                self._json(404, {"error": str(exc)})
            except ValueError as exc:
                self._json(400, {"error": str(exc)})
            except EngineOverloaded as exc:
                self._json(429, {"error": str(exc)}, headers={
                    "Retry-After": str(max(1, int(exc.retry_after)))})
            except TimeoutError as exc:
                self._json(504, {"error": str(exc)})
            except Exception as exc:   # surface, don't hide
                self._json(500, {"error": f"{type(exc).__name__}: {exc}"})
            finally:
                server.track(-1)

        def _generate_text(self, prompt: str, body: dict,
                           model: Optional[str],
                           strict: bool = False) -> tuple[str, Request]:
            return server.generate_text(prompt, body, model, strict=strict,
                                        deadline_s=self._deadline_s(),
                                        qos=self._qos(body))

        def _v1_predict(self, body: dict, model: str) -> None:
            instances = body.get("instances")
            if not isinstance(instances, list):
                raise ValueError("body must contain 'instances': [...]")
            preds = [self._generate_text(str(inst), body, model,
                                         strict=True)[0]
                     for inst in instances]
            self._json(200, {"predictions": preds})

        def _v2_infer(self, body: dict, model: str) -> None:
            inputs = body.get("inputs")
            if not isinstance(inputs, list) or not inputs:
                raise ValueError("body must contain 'inputs': [...]")
            texts = []
            for inp in inputs:
                for datum in inp.get("data", []):
                    texts.append(self._generate_text(str(datum), body,
                                                     model, strict=True)[0])
            self._json(200, {
                "model_name": model,
                "outputs": [{"name": "text", "datatype": "BYTES",
                             "shape": [len(texts)], "data": texts}],
            })

        def _completions(self, body: dict) -> None:
            model = self.headers.get(MODEL_HEADER) or body.get("model")
            prompt = body.get("prompt", "")
            if isinstance(prompt, list):
                prompt = prompt[0] if prompt else ""
            if body.get("stream"):
                return self._completions_stream(str(prompt), body,
                                                model=model)
            text, req = self._generate_text(str(prompt), body, model)
            usage = {"prompt_tokens": len(req.prompt_tokens),
                     "completion_tokens": len(req.output_tokens),
                     "total_tokens": len(req.prompt_tokens)
                     + len(req.output_tokens)}
            self._json(200, {
                "id": req.id, "object": "text_completion",
                "created": int(time.time()),
                "model": model or server.name,
                "choices": [{"index": 0, "finish_reason": req.finish_reason,
                             "text": text}],
                "usage": usage,
            })

        def _send_sse_headers(self) -> None:
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()

        def _chunk(self, data: str) -> None:
            payload = f"data: {data}\n\n".encode()
            self.wfile.write(f"{len(payload):x}\r\n".encode()
                             + payload + b"\r\n")
            self.wfile.flush()

        def _completions_stream(self, prompt: str, body: dict, *,
                                model: Optional[str]) -> None:
            req, timeout = server.submit_text(
                prompt, body, deadline_s=self._deadline_s(),
                qos=self._qos(body))
            tokenizer = server.tokenizer
            self._send_sse_headers()
            try:
                while True:
                    try:
                        tok = req.stream.get(timeout=timeout + 1.0)
                    except queue.Empty:
                        # The engine's own reaper should have ended it: this
                        # is the wedged-scheduler fallback.
                        req.cancel()
                        break
                    if tok is None:
                        break
                    if tok == tokenizer.eos_id:
                        continue
                    self._chunk(json.dumps({
                        "id": req.id, "object": "chunk",
                        "model": model or server.name,
                        "choices": [{"index": 0,
                                     "text": tokenizer.decode([tok])}]}))
            except OSError:
                # Client hung up mid-stream: free the slot now.
                req.cancel()
                self.close_connection = True
                return
            self._chunk("[DONE]")
            self.wfile.write(b"0\r\n\r\n")

    return Handler
