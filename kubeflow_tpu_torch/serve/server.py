"""Model server: the HTTP protocol surface over one port LLM engine or a
model repository (port of ``kubeflow_tpu/serve/server.py``).

Routes:

- ``GET /healthz``, ``/v2/health/ready``, ``/v2/health/live``;
  ``GET /v1/models``; ``GET /v2/models/{name}`` (metadata);
  ``GET /metrics`` (Prometheus text, the same series names as the JAX
  package's ``serving_metrics_registry``); ``GET /debug/traces`` (recent
  traces, ``?slowest=N``, ``?chrome=1``) and ``/debug/spans/export`` (the
  completed spans, for a fleet collector);
- ``POST /v1/completions``, ``/v1/chat/completions`` (OpenAI-compatible;
  ``stream=true`` → SSE);
- ``POST /v1/models/{name}:predict`` (v1 protocol);
- ``POST /v1/models/{name}:explain`` (per-token attribution from the
  configured explainer hop, ``serve/explain.py``);
- ``POST /v2/models/{name}/infer`` (v2 open-inference protocol);
- ``POST /v1/handoff`` (the decode side of disaggregated serving: adopt a
  ``serve/handoff.py`` payload and stream the second token on as SSE, each
  chunk with its token id);
- ``GET /v2/repository/index``, ``POST /v2/repository/models/{m}/load`` and
  ``.../unload`` (the model repository, serve/repository.py; a
  single-model server lists its one model and answers the actions 400).

Model ids: ``ModelServer(name, engine)`` serves one engine, and on an
engine with LoRA adapters (``BatchingSpec.lora``) every registered adapter
name is a model id too — the ``X-Kftpu-Model`` header or the body's
``"model"`` field routes a request through that adapter, and an unknown id
is a 404, never a silent fall-through to the base weights.
``ModelServer(name, repository=...)`` serves many models, loading each on
its first request under the repository's LRU budget; every request leases
its model's engine for its duration. ``grpc_port=`` adds the open inference
protocol over gRPC (serve/grpc_server.py) on the same models.

Disaggregated serving: on a ``prefill``-role engine, a request carrying
``X-Kftpu-Decode-Backend`` (the router stamps it) stops at its first
token, and the server POSTs the KV handoff to that decode replica — or to
the alternates of ``X-Kftpu-Decode-Alts``, one after another under the
retry policy of ``serve/retry.py`` — and relays its tokens. The decode
side's 200 is the ack that releases the prefill side's pages; if no
replica acks, the prefill side recomputes the request locally under
``{id}-recompute``. Without the header a prefill replica decodes locally.

Behind ``serve/router.py`` a fleet of these servers takes one URL: the
router retries a refused connection on another replica and ejects a dead
one, and with the remote KV tier on (``BatchingSpec.remote_kv_root``) the
replica that takes a conversation's next turn adopts its prefix from the
store.

A transformer hop ``transformer(text, phase)`` rewrites the prompt
(``"pre"``) and the non-streamed output (``"post"``). Threaded stdlib
server: handlers block on the engine's request stream; the engine thread
batches.
"""

from __future__ import annotations

import contextlib
import dataclasses
import http.client
import json
import queue
import re
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Optional
from urllib.parse import urlparse

from kubeflow_tpu_torch.core.headers import (
    DEADLINE_HEADER, DECODE_ALTS_HEADER, DECODE_BACKEND_HEADER,
    HANDOFF_DTYPE_HEADER, HANDOFF_WIRE_HEADER, MODEL_HEADER, QOS_HEADER,
    TRACE_HEADER,
)
from kubeflow_tpu_torch.core.serving import QOS_DEFAULT
from kubeflow_tpu_torch.obs.fleet import SPANS_EXPORT_PATH, spans_export_payload
from kubeflow_tpu_torch.obs.registry import MetricsRegistry
from kubeflow_tpu_torch.obs.trace import debug_traces_payload, get_tracer
from kubeflow_tpu_torch.serve.engine import (
    EngineOverloaded, HOST_GAP_BUCKETS, LLMEngine, QUEUE_DELAY_BUCKETS,
    Request, SamplingParams,
)
from kubeflow_tpu_torch.serve.handoff import HandoffPayload
from kubeflow_tpu_torch.serve.retry import (
    call_with_retry, env_float, handoff_policy,
)
from kubeflow_tpu_torch.serve.router import quiet_handle_error
from kubeflow_tpu_torch.serve.tokenizer import Tokenizer, get_tokenizer

#: Handoff wire versions this server adopts (serve/handoff.py): 1 = raw
#: K/V planes, 2 = with int8 scale rows. Anything else is a 409.
SUPPORTED_HANDOFF_WIRE = ("1", "2")


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


def open_handoff(decode_url: str, payload, *, chat: bool, qos: str,
                 trace_hdr: Optional[str], deadline_s: Optional[float],
                 timeout: float):
    """POST a KV handoff to a decode replica; returns ``(conn, resp)`` once
    the decode side ACKED (HTTP 200: the payload is in its memory, so the
    prefill side may release its page hold). Raises OSError on anything
    short of an ack — the caller's signal to try another replica or
    ``fail_handoff`` and recompute.

    Connect+send and the ack wait have separate budgets
    (``KFTPU_HANDOFF_CONNECT_S``, ``KFTPU_HANDOFF_ACK_S``): a dead host
    fails the connect in seconds, and a wedged decode replica fails the ack
    wait without holding the prefill's pages for the whole request
    deadline. The POST declares its cache dtype and wire version, so a
    mismatched replica rejects it (409) before reading any page byte."""
    connect_s = min(env_float("KFTPU_HANDOFF_CONNECT_S", 5.0), timeout)
    ack_s = min(env_float("KFTPU_HANDOFF_ACK_S", 30.0), timeout)
    parsed = urlparse(decode_url)
    conn = http.client.HTTPConnection(parsed.hostname or "127.0.0.1",
                                      parsed.port or 80, timeout=connect_s)
    headers = {"Content-Type": "application/octet-stream",
               QOS_HEADER: qos,
               HANDOFF_DTYPE_HEADER: payload.cache_dtype or "full",
               HANDOFF_WIRE_HEADER: "2" if payload.cache_dtype else "1"}
    if trace_hdr:
        headers[TRACE_HEADER] = trace_hdr
    if deadline_s is not None:
        headers[DEADLINE_HEADER] = str(int(max(deadline_s, 0.0) * 1e3))
    path = "/v1/handoff" + ("?chat=1" if chat else "")
    try:
        conn.request("POST", path, body=payload.to_wire(), headers=headers)
        if conn.sock is not None:
            conn.sock.settimeout(ack_s)     # the ack-hold budget
        resp = conn.getresponse()
    except (OSError, http.client.HTTPException) as exc:
        conn.close()
        raise OSError(f"handoff POST to {decode_url} failed: {exc}") from exc
    if resp.status != 200:
        body = resp.read()
        conn.close()
        raise OSError(
            f"handoff to {decode_url} rejected: HTTP {resp.status} "
            f"{body[:200]!r}")
    if conn.sock is not None:
        # Acked: the token relay may idle between decode rounds — back to
        # the request-wide budget.
        conn.sock.settimeout(timeout)
    return conn, resp


def open_handoff_with_retry(engine, candidates: list, payload, *,
                            chat: bool, qos: str, trace_fn,
                            deadline_s: Optional[float], timeout: float):
    """Try ``candidates`` in order under the handoff retry policy, each
    attempt a DIFFERENT decode replica. Returns ``(url, conn, resp)`` on the
    first ack; raises the last OSError once every candidate (or the attempt
    budget) is spent — the caller then fails the handoff and recomputes
    locally (a request is never dropped)."""
    policy = handoff_policy()
    policy = dataclasses.replace(policy, attempts=max(
        1, min(policy.attempts, len(candidates))))

    def attempt(i: int):
        url = candidates[i]
        conn, resp = open_handoff(url, payload, chat=chat, qos=qos,
                                  trace_hdr=trace_fn(), deadline_s=deadline_s,
                                  timeout=timeout)
        return url, conn, resp

    def on_retry(_attempt: int, _exc) -> None:
        engine.metrics.note_handoff("retried")

    return call_with_retry(attempt, policy=policy, on_retry=on_retry)


def iter_sse_data(resp):
    """Yield the value of every ``data:`` line of an SSE response (the
    decode replica's token chunks), ending at stream end."""
    while True:
        line = resp.readline()
        if not line:
            return
        line = line.strip()
        if not line.startswith(b"data:"):
            continue
        yield line[5:].strip().decode()


_V1_PREDICT = re.compile(r"^/v1/models/([^/:]+):predict$")
_V1_EXPLAIN = re.compile(r"^/v1/models/([^/:]+):explain$")
_V2_MODEL = re.compile(r"^/v2/models/([^/]+)$")
_V2_INFER = re.compile(r"^/v2/models/([^/]+)/infer$")
_REPO_ACTION = re.compile(r"^/v2/repository/models/([^/]+)/(load|unload)$")


class ModelServer:
    def __init__(self, name: str, engine: Optional[LLMEngine] = None, *,
                 repository=None,
                 tokenizer: Optional[Tokenizer] = None,
                 transformer=None,
                 explainer=None,
                 host: str = "127.0.0.1", port: int = 0,
                 grpc_port: Optional[int] = None):
        if (engine is None) == (repository is None):
            raise ValueError("pass exactly one of engine= or repository=")
        self.name = name                  # default model name
        self.engine = engine              # single-model mode only
        # Multi-model mode (serve/repository.py): engines load on demand
        # under an LRU budget, each request leasing its entry.
        self.repository = repository
        self.tokenizer = tokenizer or get_tokenizer("byte")
        # Pre/post-processing hop (≈ kserve transformer):
        # transformer(text, phase) with phase in {"pre", "post"}.
        self.transformer = transformer
        # Explanation hop (≈ kserve explainer): explainer(tokens,
        # params=..., cfg=...) -> attribution dict, on the v1 :explain route.
        self.explainer = explainer
        self._in_flight = 0             # guarded_by: _in_flight_lock
        self._in_flight_lock = threading.Lock()
        self.httpd = ThreadingHTTPServer((host, port), _make_handler(self))
        self.httpd.daemon_threads = True
        quiet_handle_error(self.httpd)
        self.port = self.httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None
        # The v2 protocol over gRPC beside REST (grpc_port=0: ephemeral).
        # grpcio is imported only here, so a server without it still runs.
        self.grpc_server = None
        if grpc_port is not None:
            from kubeflow_tpu_torch.serve.grpc_server import (
                GRPCInferenceServer,
            )

            self.grpc_server = GRPCInferenceServer(self, host=host,
                                                   port=grpc_port)

    # -- lifecycle -------------------------------------------------------------

    def start(self) -> None:
        if self.engine is not None:
            self.engine.start()
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True, name="model-server")
        self._thread.start()
        if self.grpc_server is not None:
            self.grpc_server.start()

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        if self.grpc_server is not None:
            self.grpc_server.stop()
        if self.engine is not None:
            self.engine.stop()
        if self.repository is not None:
            self.repository.shutdown()

    @property
    def url(self) -> str:
        return f"http://127.0.0.1:{self.port}"

    # -- model resolution ------------------------------------------------------

    def model_names(self) -> list[str]:
        if self.repository is None:
            lora = self.engine._lora
            if lora is not None:
                # Multi-tenant LoRA: every registered adapter is a servable
                # model id on this engine.
                return [self.name] + lora.names()
            return [self.name]
        return self.repository.names()

    def resolve_adapter(self, name: Optional[str]) -> Optional[str]:
        """Map a request's model id onto this server's LoRA surface:
        None or the base name = base weights; a registered adapter name
        decodes through its packed slot; anything else on a LoRA engine is
        a 404 (``KeyError``): a tenant never falls through to the base
        model. Repository and LoRA-free servers return None."""
        if self.repository is not None or name in (None, self.name):
            return None
        lora = self.engine._lora
        if lora is None:
            return None
        if not lora.known(name):
            raise KeyError(
                f"unknown model {name!r}: not a registered adapter "
                f"(serving {self.name})")
        return name

    def lease(self, name: Optional[str], *, strict: bool = False):
        """Context manager: ``(engine, tokenizer, resolved_name)`` pinned for
        the request's duration (repository mode leases the entry against
        LRU eviction and loads it on demand).

        ``strict`` (path-addressed endpoints): a single-model server 404s a
        foreign name. Non-strict (the OpenAI body "model" field) ignores it:
        OpenAI SDK clients always send one."""
        if self.repository is None:
            if strict and name not in (None, self.name):
                raise KeyError(f"unknown model {name!r} (serving {self.name})")

            @contextlib.contextmanager
            def single():
                yield self.engine, self.tokenizer, self.name

            return single()

        @contextlib.contextmanager
        def leased():
            entry = self.repository.acquire(name or self.name)
            try:
                yield entry.engine, entry.tokenizer, entry.name
            finally:
                self.repository.release(entry)

        return leased()

    def model_config(self, name: str):
        """Model metadata without forcing a load (``KeyError``: unknown)."""
        if self.repository is None:
            if name != self.name:
                lora = self.engine._lora
                if lora is not None and lora.known(name):
                    return self.engine.cfg  # an adapter: the base architecture
                raise KeyError(name)
            return self.engine.cfg
        entry = self.repository.peek(name)
        if entry is None:
            raise KeyError(name)
        return entry.cfg

    def request_timeout(self, body: dict,
                        deadline_s: Optional[float] = None) -> float:
        """The body ``timeout`` capped by the remaining client budget from
        the deadline header."""
        timeout = float(body.get("timeout", 300))
        if deadline_s is not None:
            timeout = min(timeout, max(deadline_s, 0.0))
        return timeout

    def explain_text(self, prompt: str, model: Optional[str]) -> dict:
        """Tokenize → attribution handler → per-token scores with their
        decoded token strings (the v1 ``:explain`` payload)."""
        if self.explainer is None:
            raise ValueError("no explainer configured on this service")
        if self.transformer is not None:
            prompt = self.transformer(prompt, "pre")
        with self.lease(model, strict=True) as (engine, tokenizer, _):
            toks = tokenizer.encode(prompt)
            # Attribution is O(S) forwards (leave_one_out batches an
            # [S, S] block): an uncapped prompt would exhaust the card.
            limit = min(engine.max_len, engine.cfg.max_seq_len)
            if len(toks) > limit:
                raise ValueError(
                    f"explain prompt is {len(toks)} tokens; limit {limit}")
            # On the dense MoE path; under a model axis every rank of the
            # engine computes on its shards (``LLMEngine.explain``).
            out = engine.explain(self.explainer, toks)
            out["tokens"] = [tokenizer.decode([t]) for t in toks]
            out["predicted_text"] = tokenizer.decode([out["target_token"]])
        return out

    def submit_text(self, engine: LLMEngine, tokenizer: Tokenizer,
                    prompt: str, body: dict, *, deadline_s: Optional[float],
                    qos: str, decode_url: Optional[str] = None,
                    adapter: Optional[str] = None) -> tuple:
        """Tokenize and submit; returns (request, timeout, tokens). The
        engine-side deadline equals the client budget, so the scheduler
        reaps the request the moment the client can no longer use the
        answer. On a prefill-role engine, a ``decode_url`` makes the
        request stop at its first token for a handoff; without one it
        decodes locally."""
        timeout = self.request_timeout(body, deadline_s)
        toks = tokenizer.encode(prompt)
        handoff = (bool(decode_url) if engine.role == "prefill" else None)
        req = engine.submit(toks, self.sampling_from(body, tokenizer),
                            deadline=time.monotonic() + timeout,
                            trace_parent=get_tracer().current(), qos=qos,
                            handoff=handoff, adapter=adapter)
        return req, timeout, toks

    def generate_text(self, prompt: str, body: dict, model: Optional[str],
                      strict: bool = False,
                      deadline_s: Optional[float] = None,
                      qos: str = QOS_DEFAULT,
                      decode_url: Optional[str] = None,
                      decode_alts: tuple = ()) -> tuple[str, Request]:
        """Pre-hop → tokenize → engine (→ handoff relay) → detokenize →
        post-hop: the one generation path every non-streaming surface (REST
        v1/v2, OpenAI, gRPC ``ModelInfer``) shares. An adapter id leases
        the base engine and decodes through the adapter's packed slot."""
        if self.transformer is not None:
            prompt = self.transformer(prompt, "pre")
        adapter = self.resolve_adapter(model)
        with self.lease(None if adapter else model,
                        strict=strict) as (engine, tokenizer, _):
            req, timeout, toks = self.submit_text(
                engine, tokenizer, prompt, body, deadline_s=deadline_s,
                qos=qos, decode_url=decode_url, adapter=adapter)
            try:
                out = req.result(timeout=timeout + 1.0)
            except TimeoutError:
                req.cancel()
                raise
            if req.finish_reason == "handoff":
                text = self._relay_handoff_text(
                    engine, tokenizer, req, toks, body, decode_url, qos=qos,
                    timeout=timeout, decode_alts=decode_alts)
            else:
                _raise_for_reaped(req)
                with get_tracer().span("server.detokenize", tokens=len(out)):
                    text = tokenizer.decode(
                        [t for t in out if t != tokenizer.eos_id])
        if self.transformer is not None:
            text = self.transformer(text, "post")
        return text, req

    def _relay_handoff_text(self, engine: LLMEngine, tokenizer: Tokenizer,
                            req: Request, toks: list[int], body: dict,
                            decode_url: str, *, qos: str, timeout: float,
                            decode_alts: tuple = ()) -> str:
        """Non-streaming half of the handoff relay: POST the payload, then
        join the decode replica's tokens after the locally sampled first
        token. A failure before the ack tries the next decode replica;
        when none acks, the request is recomputed locally (a failed
        handoff costs a prefill, never the request)."""
        tracer = get_tracer()
        deadline = time.monotonic() + timeout
        candidates = [decode_url] + [u for u in decode_alts
                                     if u and u != decode_url]
        with tracer.span("engine.handoff", backend=decode_url,
                         request=req.id) as sp:
            try:
                used_url, conn, resp = open_handoff_with_retry(
                    engine, candidates, req.handoff, chat=False, qos=qos,
                    trace_fn=lambda: tracer.inject(sp),
                    deadline_s=timeout, timeout=timeout + 5.0)
                sp.set_attrs(backend=used_url)
                if used_url != decode_url:
                    sp.add_event("connect_failure", backend=decode_url)
            except OSError as exc:
                sp.set_attrs(error=str(exc), fallback="recompute")
                engine.metrics.note_handoff("fallback")
                engine.fail_handoff(req.id)
                return self._recompute_locally(engine, tokenizer, req, toks,
                                               body, qos=qos, timeout=timeout)
            engine.complete_handoff(req.id)
            # Collect the raw token ids (the handoff SSE carries them) and
            # decode the WHOLE sequence once: piecewise decoding would
            # split multi-byte characters the unified path decodes whole.
            tokens = list(req.output_tokens)
            try:
                try:
                    for data in iter_sse_data(resp):
                        if data == "[DONE]":
                            break
                        choice = json.loads(data)["choices"][0]
                        tokens.append(int(choice["token"]))
                        if time.monotonic() > deadline + 1.0:
                            raise TimeoutError(
                                f"handoff relay for {req.id} exceeded "
                                "its deadline")
                finally:
                    conn.close()
            except (OSError, ValueError, KeyError) as exc:
                # After the ack the pages are gone: the decode side died
                # mid-stream, and that is an explicit error.
                raise RuntimeError(
                    f"decode replica failed mid-handoff for {req.id}: "
                    f"{exc}") from exc
            sp.set_attrs(tokens=len(tokens))
        return tokenizer.decode([t for t in tokens if t != tokenizer.eos_id])

    def _recompute_locally(self, engine: LLMEngine, tokenizer: Tokenizer,
                           req: Request, toks: list[int], body: dict, *,
                           qos: str, timeout: float) -> str:
        """Handoff failure = recompute: run the request again as a local
        decode (the prefix index usually makes the second prefill short)."""
        req2 = self.recompute_request(engine, tokenizer, req, toks, body,
                                      qos=qos, timeout=timeout)
        try:
            out = req2.result(timeout=timeout + 1.0)
        except TimeoutError:
            req2.cancel()
            raise
        _raise_for_reaped(req2)
        return tokenizer.decode([t for t in out if t != tokenizer.eos_id])

    def recompute_request(self, engine: LLMEngine, tokenizer: Tokenizer,
                          req: Request, toks: list[int], body: dict, *,
                          qos: str, timeout: float) -> Request:
        return engine.submit(
            toks, self.sampling_from(body, tokenizer),
            deadline=time.monotonic() + timeout,
            trace_parent=get_tracer().current(), qos=qos, handoff=False,
            request_id=f"{req.id}-recompute")

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

    def metrics_registry(self) -> MetricsRegistry:
        """Scrape-time registry over the live engine counters: the single
        engine, or every loaded repository entry (``peek`` only: a scrape
        neither loads a model nor touches LRU recency)."""
        engines: list[tuple[str, LLMEngine]] = []
        if self.engine is not None:
            engines.append((self.name, self.engine))
        else:
            for item in self.repository.index():
                entry = self.repository.peek(item["name"])
                if entry is not None and entry.engine is not None:
                    engines.append((entry.name, entry.engine))
        return serving_metrics_registry(engines, in_flight=self.in_flight)

    def metrics_text(self) -> str:
        return self.metrics_registry().render()


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
            if self.path.startswith("/debug/traces"):
                return self._json(200, debug_traces_payload(self.path))
            if self.path.startswith(SPANS_EXPORT_PATH):
                return self._json(200, spans_export_payload(
                    process=f"server:{server.name}"))
            if self.path == "/v1/models":
                return self._json(200, {"models": server.model_names()})
            if self.path == "/v2/repository/index":
                if server.repository is None:
                    return self._json(200, {"models": [
                        {"name": server.name, "state": "READY"}]})
                return self._json(200, {"models": server.repository.index()})
            m = _V2_MODEL.match(self.path)
            if m:
                try:
                    cfg = server.model_config(m.group(1))
                except KeyError:
                    return self._json(404, {"error": f"no model {m.group(1)}"})
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
                    if self.path.split("?", 1)[0] == "/v1/handoff":
                        # A binary payload: it must not ride the JSON drain.
                        return self._handoff()
                    # Drain the body first: keep-alive breaks on unread bytes.
                    body = self._body()
                    repo = _REPO_ACTION.match(self.path)
                    if repo:
                        return self._repository_action(repo.group(1),
                                                       repo.group(2))
                    m = _V1_PREDICT.match(self.path)
                    if m:
                        return self._v1_predict(body, m.group(1))
                    m = _V1_EXPLAIN.match(self.path)
                    if m:
                        return self._v1_explain(body, m.group(1))
                    m = _V2_INFER.match(self.path)
                    if m:
                        return self._v2_infer(body, m.group(1))
                    if self.path == "/v1/completions":
                        return self._completions(body, chat=False)
                    if self.path == "/v1/chat/completions":
                        return self._completions(body, chat=True)
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

        def _repository_action(self, name: str, action: str) -> None:
            if server.repository is None:
                return self._json(400, {"error": "single-model server"})
            if action == "load":
                server.repository.load(name)
            else:
                server.repository.unload(name)
            self._json(200, {"name": name, "state": "READY"
                             if action == "load" else "UNLOADED"})

        def _model_id(self, body: dict) -> Optional[str]:
            """Requested model id: the ``X-Kftpu-Model`` header (the router's
            routing key) wins; the OpenAI ``"model"`` body field is the
            headerless fallback."""
            hdr = self.headers.get(MODEL_HEADER)
            return hdr.strip() if hdr else body.get("model")

        def _decode_backend(self) -> Optional[str]:
            """The decode replica the router picked for this request's KV
            handoff (absent = decode locally)."""
            url = self.headers.get(DECODE_BACKEND_HEADER)
            return url.strip() if url else None

        def _decode_alts(self) -> tuple:
            """Alternate decode replicas for the handoff's retry (absent =
            no retry)."""
            raw = self.headers.get(DECODE_ALTS_HEADER) or ""
            return tuple(u.strip() for u in raw.split(",") if u.strip())

        def _generate_text(self, prompt: str, body: dict,
                           model: Optional[str],
                           strict: bool = False) -> tuple[str, Request]:
            return server.generate_text(prompt, body, model, strict=strict,
                                        deadline_s=self._deadline_s(),
                                        qos=self._qos(body),
                                        decode_url=self._decode_backend(),
                                        decode_alts=self._decode_alts())

        def _v1_predict(self, body: dict, model: str) -> None:
            instances = body.get("instances")
            if not isinstance(instances, list):
                raise ValueError("body must contain 'instances': [...]")
            preds = [self._generate_text(str(inst), body, model,
                                         strict=True)[0]
                     for inst in instances]
            self._json(200, {"predictions": preds})

        def _v1_explain(self, body: dict, model: str) -> None:
            instances = body.get("instances")
            if not isinstance(instances, list):
                raise ValueError("body must contain 'instances': [...]")
            exps = [server.explain_text(str(inst), model)
                    for inst in instances]
            self._json(200, {"explanations": exps})

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

        def _completions(self, body: dict, *, chat: bool) -> None:
            model = self._model_id(body)
            if chat:
                msgs = body.get("messages", [])
                prompt = "\n".join(
                    f"{m.get('role', 'user')}: {m.get('content', '')}"
                    for m in msgs) + "\nassistant:"
            else:
                prompt = body.get("prompt", "")
                if isinstance(prompt, list):
                    prompt = prompt[0] if prompt else ""
            if body.get("stream"):
                return self._completions_stream(str(prompt), body, chat=chat,
                                                model=model)
            text, req = self._generate_text(str(prompt), body, model)
            usage = {"prompt_tokens": len(req.prompt_tokens),
                     "completion_tokens": len(req.output_tokens),
                     "total_tokens": len(req.prompt_tokens)
                     + len(req.output_tokens)}
            if chat:
                choice = {"index": 0, "finish_reason": req.finish_reason,
                          "message": {"role": "assistant", "content": text}}
                obj = "chat.completion"
            else:
                choice = {"index": 0, "finish_reason": req.finish_reason,
                          "text": text}
                obj = "text_completion"
            self._json(200, {
                "id": req.id, "object": obj, "created": int(time.time()),
                "model": model or server.name, "choices": [choice],
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

        def _stream_tokens(self, req: Request, tokenizer: Tokenizer, *,
                           chat: bool, model: Optional[str], timeout: float,
                           with_token_ids: bool = False) -> None:
            """Send SSE headers and stream one engine request's tokens (the
            local-decode half of every streaming path: unified, the decode
            side of a handoff, and the recompute fallback).
            ``with_token_ids`` adds each raw token id to its chunk: the
            handoff relay re-decodes the WHOLE sequence from them."""
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
                    self._chunk(json.dumps(self._delta(
                        req, tokenizer.decode([tok]), chat=chat,
                        model=model, token=tok if with_token_ids else None)))
            except OSError:
                # Client hung up mid-stream: free the slot now.
                req.cancel()
                self.close_connection = True
                return
            self._chunk("[DONE]")
            self.wfile.write(b"0\r\n\r\n")

        @staticmethod
        def _delta(req: Request, piece: str, *, chat: bool,
                   model: Optional[str], token: Optional[int] = None) -> dict:
            if chat:
                choice = {"index": 0, "delta": {"content": piece}}
            else:
                choice = {"index": 0, "text": piece}
            if token is not None:
                choice["token"] = token
            return {"id": req.id, "object": "chunk",
                    "model": model or server.name, "choices": [choice]}

        def _completions_stream(self, prompt: str, body: dict, *,
                                chat: bool, model: Optional[str]) -> None:
            # The pre-hook applies to the prompt as on the non-streaming
            # path; the post-hook cannot (output streams piecewise), as in
            # kserve's non-streaming transformer scope.
            if server.transformer is not None:
                prompt = server.transformer(prompt, "pre")
            adapter = server.resolve_adapter(model)
            with server.lease(None if adapter else model) \
                    as (engine, tokenizer, _):
                decode_url = self._decode_backend()
                req, timeout, toks = server.submit_text(
                    engine, tokenizer, prompt, body,
                    deadline_s=self._deadline_s(), qos=self._qos(body),
                    decode_url=decode_url, adapter=adapter)
                if engine.role == "prefill" and decode_url:
                    return self._stream_disaggregated(
                        engine, tokenizer, req, toks, body, decode_url,
                        chat=chat, model=model, timeout=timeout,
                        decode_alts=self._decode_alts())
                self._stream_tokens(req, tokenizer, chat=chat, model=model,
                                    timeout=timeout)

        def _stream_disaggregated(self, engine: LLMEngine,
                                  tokenizer: Tokenizer, req: Request,
                                  toks: list[int], body: dict,
                                  decode_url: str, *, chat: bool,
                                  model: Optional[str], timeout: float,
                                  decode_alts: tuple = ()) -> None:
            """Streaming handoff relay. The client's SSE response opens only
            AFTER the decode side acks (or the fallback engages), so a
            prefill replica that dies mid-handoff has written no response
            byte, and the client may retry elsewhere."""
            tracer = get_tracer()
            if not req.done.wait(timeout + 1.0):
                req.cancel()
                return self._json(504, {"error": f"request {req.id} timed "
                                        "out in prefill"})
            if req.finish_reason != "handoff":
                # Finished at the first token (stop/length): nothing to hand
                # off; stream the one-token answer.
                if req.finish_reason in ("stop", "length"):
                    return self._stream_tokens(req, tokenizer, chat=chat,
                                               model=model, timeout=timeout)
                _raise_for_reaped(req)
                raise RuntimeError(
                    f"request {req.id} ended {req.finish_reason!r}")
            candidates = [decode_url] + [u for u in decode_alts
                                         if u and u != decode_url]
            with tracer.span("engine.handoff", backend=decode_url,
                             request=req.id) as sp:
                try:
                    used_url, conn, resp = open_handoff_with_retry(
                        engine, candidates, req.handoff, chat=chat,
                        qos=self._qos(body),
                        trace_fn=lambda: tracer.inject(sp),
                        deadline_s=timeout, timeout=timeout + 5.0)
                    sp.set_attrs(backend=used_url)
                    if used_url != decode_url:
                        sp.add_event("connect_failure", backend=decode_url)
                except OSError as exc:
                    # No replica acked: recompute locally (failure costs a
                    # prefill, never the request).
                    sp.set_attrs(error=str(exc), fallback="recompute")
                    engine.metrics.note_handoff("fallback")
                    engine.fail_handoff(req.id)
                    req2 = server.recompute_request(
                        engine, tokenizer, req, toks, body,
                        qos=self._qos(body), timeout=timeout)
                    return self._stream_tokens(req2, tokenizer, chat=chat,
                                               model=model, timeout=timeout)
                engine.complete_handoff(req.id)
            self._send_sse_headers()
            try:
                # The first token was sampled here; its chunk opens the
                # client stream, then the decode chunks relay verbatim.
                first = [t for t in req.output_tokens
                         if t != tokenizer.eos_id]
                if first:
                    self._chunk(json.dumps(self._delta(
                        req, tokenizer.decode(first), chat=chat,
                        model=model)))
                done = False
                try:
                    for data in iter_sse_data(resp):
                        self._chunk(data)
                        if data == "[DONE]":
                            done = True
                            break
                finally:
                    conn.close()
                if done:
                    self.wfile.write(b"0\r\n\r\n")
                    return
                # Upstream ended without [DONE]: the decode side died
                # mid-stream — close, so the client sees an explicit error.
                self.close_connection = True
            except OSError:
                self.close_connection = True

        def _handoff(self) -> None:
            """The decode side of a handoff: adopt the payload into this
            engine's pool and stream the SECOND token on as SSE. The 200
            response line IS the ack: the payload is in this process's
            memory, so the prefill side's page hold may release. A wire
            version or cache dtype this pool cannot take is a 409 before
            any page byte is read."""
            if server.engine is None:
                return self._json(
                    400, {"error": "handoff needs a single-engine server"})
            wire_v = (self.headers.get(HANDOFF_WIRE_HEADER) or "").strip()
            if wire_v and wire_v not in SUPPORTED_HANDOFF_WIRE:
                return self._json(409, {
                    "error": f"handoff wire version {wire_v!r} not "
                             f"supported (speaks {SUPPORTED_HANDOFF_WIRE})"})
            dtype = (self.headers.get(HANDOFF_DTYPE_HEADER) or "").strip()
            want = "int8" if server.engine.kv_quant else "full"
            if dtype and dtype != want:
                return self._json(409, {
                    "error": f"handoff cache-dtype mismatch: payload is "
                             f"{dtype!r}, this pool stores {want!r}"})
            n = int(self.headers.get("Content-Length", 0))
            raw = self.rfile.read(n)
            chat = "chat=1" in (self.path.split("?", 1) + [""])[1]
            payload = HandoffPayload.from_wire(raw)
            deadline_s = self._deadline_s()
            timeout = deadline_s if deadline_s is not None else 300.0
            try:
                req = server.engine.submit_handoff(
                    payload, deadline=time.monotonic() + timeout,
                    trace_parent=get_tracer().current())
            except ValueError as exc:
                # submit_handoff's own checks (shape, dtype, length) back
                # up the headers: the same clean reject.
                return self._json(409, {"error": str(exc)})
            self._stream_tokens(req, server.tokenizer, chat=chat, model=None,
                                timeout=timeout, with_token_ids=True)

    return Handler
