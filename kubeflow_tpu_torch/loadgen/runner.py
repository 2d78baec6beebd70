"""Open-loop scenario replay against a live engine or model server (a
copy of ``kubeflow_tpu/loadgen/runner.py`` for the port's ``LLMEngine``
and ``ModelServer``).

The runner fires each ``ScheduledRequest`` at its scheduled wall-clock
offset regardless of how the previous ones are doing — the open-loop
discipline (a closed-loop client pool measures capacity under perfect
backpressure and HIDES queueing collapse; an open-loop generator exposes
it, which is the entire point of the scenario model). Each request runs
on its own thread; at smoke/bench scale (tens to hundreds of in-flight
requests) an OS thread per request is far below the model server's own
thread-per-connection cost.

Two targets:

- ``EngineTarget`` — direct ``LLMEngine.submit`` with a per-request
  ``loadgen.request`` root span as ``trace_parent``, so the engine's
  queued → prefill → decode phase spans join the loadgen's trace;
- ``ServerTarget`` — HTTP against a running ``ModelServer`` URL:
  ``POST /v1/completions`` with ``stream=true`` (TTFT = first SSE
  chunk), the QoS class on the ``X-Kftpu-Qos`` header and the trace
  context on ``X-Kftpu-Trace`` — the full protocol path the fleet runs.

Every outcome records client-observed TTFT/total latency/token count
plus ``lag_s`` — how late the generator itself fired versus the
schedule (a loadgen that cannot keep up with its own schedule reports
it instead of silently measuring a slower workload).
"""

from __future__ import annotations

import dataclasses
import http.client
import json
import threading
import time
from typing import Any, Optional
from urllib.parse import urlparse

from kubeflow_tpu_torch.core.headers import (
    MODEL_HEADER, QOS_HEADER, TRACE_HEADER,
)
from kubeflow_tpu_torch.obs.trace import Tracer, get_tracer
from kubeflow_tpu_torch.loadgen.scenario import (
    Scenario, ScheduledRequest, build_schedule,
)


@dataclasses.dataclass
class RequestOutcome:
    """Client-observed result of one scheduled request."""

    idx: int
    qos: str
    scheduled_t: float          # offset the schedule asked for
    lag_s: float                # how late the generator actually fired
    ttft_s: Optional[float]     # first token/chunk latency; None = none seen
    latency_s: float            # submit → terminal
    tokens: int
    status: str                 # ok | shed | timeout | error
    #: Model id the request targeted (None = base model) — the
    #: per-adapter TTFT/TPOT split key in the attribution report.
    adapter: Optional[str] = None
    trace_id: str = ""
    #: Generated output in the target's native space (token tuple for
    #: EngineTarget, text for ServerTarget) — what session mode
    #: prepends to the next turn's prompt. Empty outside session runs.
    gen: Any = ()
    #: Length of the prompt actually sent (session mode: the COMPOSED
    #: conversation, not just the new turn) — the offered-prefill-work
    #: denominator perf gates divide by.
    prompt_len: int = 0

    @property
    def ok(self) -> bool:
        return self.status == "ok"

    def tpot_s(self) -> Optional[float]:
        """Mean time-per-output-token past the first (None under 2
        tokens — a single-token answer has no decode cadence)."""
        if self.ttft_s is None or self.tokens < 2:
            return None
        return (self.latency_s - self.ttft_s) / (self.tokens - 1)


class EngineTarget:
    """Direct in-process replay against one ``LLMEngine`` (started)."""

    def __init__(self, engine):
        self.engine = engine

    def base_prompt(self, sr: ScheduledRequest):
        return list(sr.prompt_tokens)

    def compose(self, prev_prompt, prev_gen, sr: ScheduledRequest):
        """Session mode: this turn's prompt = the conversation so far
        (previous resolved prompt + its ACTUAL output) + new tokens —
        the exact re-arrival shape the radix prefix index matches."""
        return list(prev_prompt) + list(prev_gen) + list(sr.prompt_tokens)

    def issue(self, sr: ScheduledRequest, root, timeout_s: float,
              prompt=None) -> RequestOutcome:
        from kubeflow_tpu_torch.serve.engine import (
            EngineOverloaded, SamplingParams,
        )

        prompt_tokens = (list(sr.prompt_tokens) if prompt is None
                         else list(prompt))
        t0 = time.perf_counter()
        try:
            req = self.engine.submit(
                prompt_tokens,
                SamplingParams(max_new_tokens=sr.max_new_tokens,
                               temperature=0.0),
                deadline=time.monotonic() + timeout_s,
                trace_parent=root, qos=sr.qos, adapter=sr.adapter)
        except KeyError:
            # Unknown model id: the engine 404s it at the door.
            return RequestOutcome(
                idx=sr.idx, qos=sr.qos, scheduled_t=sr.t, lag_s=0.0,
                ttft_s=None, latency_s=time.perf_counter() - t0,
                tokens=0, status="error", adapter=sr.adapter,
                prompt_len=len(prompt_tokens))
        except EngineOverloaded:
            return RequestOutcome(
                idx=sr.idx, qos=sr.qos, scheduled_t=sr.t, lag_s=0.0,
                ttft_s=None, latency_s=time.perf_counter() - t0,
                tokens=0, status="shed", adapter=sr.adapter,
                prompt_len=len(prompt_tokens))
        ttft = None
        out_tokens: list[int] = []
        status = "ok"
        deadline = t0 + timeout_s + 1.0
        while True:
            try:
                tok = req.stream.get(timeout=max(
                    deadline - time.perf_counter(), 0.01))
            except Exception:            # queue.Empty: wedged engine
                req.cancel()
                status = "timeout"
                break
            if tok is None:
                break
            out_tokens.append(tok)
            if ttft is None:
                ttft = time.perf_counter() - t0
        if status == "ok" and req.finish_reason not in ("stop", "length"):
            status = ("shed" if req.finish_reason == "shed" else "error")
        return RequestOutcome(
            idx=sr.idx, qos=sr.qos, scheduled_t=sr.t, lag_s=0.0,
            ttft_s=ttft, latency_s=time.perf_counter() - t0,
            tokens=len(out_tokens), status=status, adapter=sr.adapter,
            gen=tuple(out_tokens), prompt_len=len(prompt_tokens))


def tokens_to_text(tokens) -> str:
    """Deterministic token → printable-ASCII mapping for the HTTP path:
    one char per token, so prompt LENGTH and shared-prefix structure
    survive the byte tokenizer round-trip exactly."""
    return "".join(chr(33 + (t % 94)) for t in tokens)


class ServerTarget:
    """HTTP SSE replay against a running model-server URL."""

    def __init__(self, url: str, model: Optional[str] = None):
        parsed = urlparse(url)
        self.host = parsed.hostname or "127.0.0.1"
        self.port = parsed.port or 80
        self.model = model

    def base_prompt(self, sr: ScheduledRequest):
        return tokens_to_text(sr.prompt_tokens)

    def compose(self, prev_prompt, prev_gen, sr: ScheduledRequest):
        """Session mode in TEXT space: the server re-tokenizes the
        composed prompt, so prefix structure survives the round-trip
        (tokens_to_text is deterministic per token)."""
        return str(prev_prompt) + str(prev_gen) \
            + tokens_to_text(sr.prompt_tokens)

    def issue(self, sr: ScheduledRequest, root, timeout_s: float,
              prompt=None) -> RequestOutcome:
        t0 = time.perf_counter()
        prompt_text = (self.base_prompt(sr) if prompt is None
                       else str(prompt))
        model = sr.adapter or self.model
        body = {"prompt": prompt_text,
                "max_tokens": sr.max_new_tokens, "temperature": 0.0,
                "stream": True, "timeout": timeout_s}
        if model:
            body["model"] = model
        payload = json.dumps(body)
        headers = {"Content-Type": "application/json",
                   QOS_HEADER: sr.qos}
        if model:
            # The fleet router's model-id routing key (the body field
            # is the headerless fallback the replica reads).
            headers[MODEL_HEADER] = model
        if root is not None and getattr(root, "context", None) is not None:
            headers[TRACE_HEADER] = root.context.header_value()
        conn = http.client.HTTPConnection(self.host, self.port,
                                          timeout=timeout_s + 5.0)
        ttft = None
        tokens = 0
        pieces: list[str] = []
        status = "ok"
        try:
            conn.request("POST", "/v1/completions", body=payload,
                         headers=headers)
            resp = conn.getresponse()
            if resp.status == 429:
                resp.read()
                status = "shed"
            elif resp.status != 200:
                resp.read()
                status = "error"
            else:
                # SSE: every "data: {...}" line is one streamed token;
                # "data: [DONE]" terminates.
                while True:
                    line = resp.readline()
                    if not line:
                        break
                    line = line.strip()
                    if not line.startswith(b"data:"):
                        continue
                    data = line[5:].strip()
                    if data == b"[DONE]":
                        break
                    tokens += 1
                    if ttft is None:
                        ttft = time.perf_counter() - t0
                    try:
                        chunk = json.loads(data)
                        pieces.append(
                            chunk["choices"][0].get("text", ""))
                    except (ValueError, KeyError, IndexError):
                        pass        # non-JSON chunk: no text to carry
        except (OSError, http.client.HTTPException):
            status = "timeout" if time.perf_counter() - t0 >= timeout_s \
                else "error"
        finally:
            conn.close()
        return RequestOutcome(
            idx=sr.idx, qos=sr.qos, scheduled_t=sr.t, lag_s=0.0,
            ttft_s=ttft, latency_s=time.perf_counter() - t0,
            tokens=tokens, status=status, adapter=sr.adapter,
            gen="".join(pieces), prompt_len=len(prompt_text))


@dataclasses.dataclass
class ScenarioRun:
    """Raw material ``loadgen.report`` turns into an attribution report."""

    scenario: Scenario
    outcomes: list
    wall_s: float
    schedule: list              # the ScheduledRequests actually replayed


def run_scenario(target, scenario: Scenario, *, vocab_size: int,
                 max_prompt_len: int,
                 tracer: Optional[Tracer] = None) -> ScenarioRun:
    """Replay one scenario open-loop and return every outcome.

    The dispatcher thread (this call) sleeps to each request's scheduled
    offset and fires it on a fresh worker thread; it never waits for
    completions mid-schedule. ``wall_s`` spans first fire → last
    completion."""
    tracer = tracer or get_tracer()
    schedule = build_schedule(scenario, vocab_size=vocab_size,
                              max_prompt_len=max_prompt_len)
    outcomes: list[RequestOutcome] = []
    lock = threading.Lock()
    # Session mode (multi-turn conversations): each turn waits for its
    # predecessor, thinks, then fires with the composed conversation
    # prompt. The maps below are the cross-turn handoff state.
    turn_done: dict[int, threading.Event] = (
        {sr.idx: threading.Event() for sr in schedule}
        if scenario.turns > 1 else {})
    resolved: dict[int, object] = {}       # idx -> prompt actually sent
    gen_of: dict[int, object] = {}         # idx -> actual output
    done_at: dict[int, float] = {}         # idx -> completion perf time

    def fire(sr: ScheduledRequest, lag: float) -> None:
        prompt = None
        if sr.prev_idx is not None:
            # Closed-loop WITHIN the session (a user types after
            # reading), open-loop across sessions. A predecessor that
            # never completes bounds the wait — the turn then fires
            # with whatever the conversation produced so far.
            ev = turn_done.get(sr.prev_idx)
            if ev is not None:
                ev.wait(timeout=scenario.request_timeout_s + 30.0)
            with lock:
                prev_prompt = resolved.get(sr.prev_idx,
                                           target.base_prompt(sr))
                prev_gen = gen_of.get(sr.prev_idx, ())
                prev_t = done_at.get(sr.prev_idx)
            if sr.think_s and prev_t is not None:
                gap = prev_t + sr.think_s - time.perf_counter()
                if gap > 0:
                    time.sleep(gap)
            prompt = target.compose(prev_prompt, prev_gen, sr)
        root = tracer.start_span("loadgen.request", scenario=scenario.name,
                                 request_idx=sr.idx, qos=sr.qos)
        try:
            out = target.issue(sr, root, scenario.request_timeout_s,
                               prompt=prompt)
        except Exception as exc:  # a client bug must not hang the join
            root.set_attrs(error=f"{type(exc).__name__}: {exc}")
            out = RequestOutcome(
                idx=sr.idx, qos=sr.qos, scheduled_t=sr.t, lag_s=lag,
                ttft_s=None, latency_s=0.0, tokens=0, status="error",
                adapter=sr.adapter)
        out.lag_s = lag
        out.trace_id = getattr(root, "trace_id", "") or ""
        root.end("ok" if out.ok else out.status)
        with lock:
            outcomes.append(out)
            resolved[sr.idx] = (prompt if prompt is not None
                                else target.base_prompt(sr))
            gen_of[sr.idx] = out.gen
            done_at[sr.idx] = time.perf_counter()
        ev = turn_done.get(sr.idx)
        if ev is not None:
            ev.set()

    threads: list[threading.Thread] = []
    t0 = time.perf_counter()
    for sr in schedule:
        delay = t0 + sr.t - time.perf_counter()
        if delay > 0:
            time.sleep(delay)
        lag = max(time.perf_counter() - (t0 + sr.t), 0.0)
        th = threading.Thread(target=fire, args=(sr, lag),
                              name=f"loadgen-{scenario.name}-{sr.idx}",
                              daemon=True)
        th.start()
        threads.append(th)
    # Session turns serialize behind their predecessors: the no-hang
    # bound scales with the conversation depth.
    join_deadline = time.perf_counter() + 30.0 + scenario.turns * (
        scenario.request_timeout_s + scenario.think_time_s)
    for th in threads:
        th.join(timeout=max(join_deadline - time.perf_counter(), 0.1))
    wall = time.perf_counter() - t0
    with lock:
        done = list(outcomes)
    if len(done) != len(schedule):
        # A worker that never reported is itself a finding — record it
        # as a timeout rather than under-counting offered load.
        reported = {o.idx for o in done}
        for sr in schedule:
            if sr.idx not in reported:
                done.append(RequestOutcome(
                    idx=sr.idx, qos=sr.qos, scheduled_t=sr.t, lag_s=0.0,
                    ttft_s=None, latency_s=wall, tokens=0,
                    status="timeout", adapter=sr.adapter))
    done.sort(key=lambda o: o.idx)
    return ScenarioRun(scenario=scenario, outcomes=done, wall_s=wall,
                       schedule=schedule)
