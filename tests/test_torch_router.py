"""The port's router (``kubeflow_tpu_torch/serve/router.py``) against the
JAX router on the CPU: ``_rendezvous``, ``_affinity_key`` and
``_parse_signals`` give the same values on the same inputs;
``pick_disaggregated`` and ``decode_alternates`` make the same picks from
the same signals and failures; the ejection, half-open and panic timeline
runs the same under one fake clock. Then the port router alone: parking
with no backend until ``set_backends`` wakes it, and, through a real port
``ModelServer``, the connect-failure retry onto another backend with the
deadline restamped from the router's budget.

Router randomness: the group pick draws ``random.uniform`` and round-robin
counts with ``itertools.count``; parity runs use one group (where the draw
cannot change the pick) and fresh routers, so both counters start at 0."""

import json
import socket
import threading
import time
import types
import urllib.request

import pytest

jax = pytest.importorskip("jax")

from kubeflow_tpu.serve import router as jrouter  # noqa: E402
from kubeflow_tpu_torch.serve import router as trouter  # noqa: E402
from port_threads import torch_on_one_thread  # noqa: E402,F401

URLS = [f"http://10.0.0.{i}:8000" for i in range(1, 7)]


def dead_url() -> str:
    """A URL that refuses connections (bound once, then closed)."""
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return f"http://127.0.0.1:{port}"


class EchoBackend:
    """Answers every request with {"backend": <name>}."""

    def __init__(self, name: str):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        backend_name = name

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *args):
                pass

            def _do(self):
                n = int(self.headers.get("Content-Length", 0))
                if n:
                    self.rfile.read(n)
                data = json.dumps({"backend": backend_name}).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            do_GET = _do
            do_POST = _do

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.httpd.daemon_threads = True
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}"
        threading.Thread(target=self.httpd.serve_forever, daemon=True).start()

    def stop(self):
        self.httpd.shutdown()
        self.httpd.server_close()


class FakeClock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self) -> float:
        return self.t


def _routers(monkeypatch, **kw):
    """One JAX and one port router (not started), both on one fake clock."""
    clock = FakeClock()
    fake = types.SimpleNamespace(monotonic=clock, time=time.time,
                                 sleep=time.sleep)
    out = []
    for mod in (jrouter, trouter):
        monkeypatch.setattr(mod, "time", fake)
        out.append(mod.Router(**kw))
    return out, clock


@pytest.mark.parametrize("key", ["", "sys: you are terse", "x" * 64,
                                 "ünïcode prompt"])
def test_rendezvous_scores_equal_the_jax_router(key):
    for url in URLS:
        assert trouter._rendezvous(key, url) == jrouter._rendezvous(key, url)
    best = max(URLS, key=lambda u: trouter._rendezvous(key, u))
    assert best == max(URLS, key=lambda u: jrouter._rendezvous(key, u))


@pytest.mark.parametrize("path,body", [
    ("/v1/completions", {"prompt": "tell me a story " * 8}),
    ("/v1/completions", {"prompt": ""}),
    ("/v1/completions", {"prompt": ["not", "a", "string"]}),
    ("/v1/chat/completions", {"messages": [{"role": "system",
                                            "content": "be brief"}]}),
    ("/v1/chat/completions", {"messages": []}),
    ("/v1/chat/completions", {"messages": ["oops"]}),
    ("/v1/models/m:predict", {"prompt": "ignored"}),
    ("/v1/completions", None),
    ("/v1/completions", "not json"),
], ids=["prompt", "empty", "list", "chat", "no-msgs", "bad-msg", "predict",
        "no-body", "garbage"])
def test_affinity_key_equals_the_jax_router(path, body):
    raw = None if body is None else (
        body.encode() if isinstance(body, str) else json.dumps(body).encode())
    assert trouter._affinity_key(path, raw) == jrouter._affinity_key(path, raw)


def _exposition(**vals) -> str:
    from kubeflow_tpu_torch.obs.registry import MetricsRegistry

    reg = MetricsRegistry()
    for name, v in vals.items():
        reg.gauge(f"kftpu_engine_{name}").set(v, model="m")
    g = reg.gauge("kftpu_engine_adapters_resident")
    g.set(0)
    g.set(1, adapter="sql")
    g.set(0, adapter="cold")
    reg.gauge("kftpu_serving_in_flight").set(3)
    reg.gauge("kftpu_other_series").set(99)
    return reg.render()


@pytest.mark.parametrize("text", [
    _exposition(pending_prefill_tokens=512, kv_pages_resident=9,
                kv_pages_cached=4, kv_pages_remote=6),
    _exposition(kv_pages_remote=0),
    "",
    "this is { not exposition",
], ids=["full", "zeros", "empty", "garbage"])
def test_parse_signals_equals_the_jax_router(text):
    assert trouter.Router._parse_signals(text) == \
        jrouter.Router._parse_signals(text)


def test_parse_signals_reads_a_port_server_with_the_remote_tier(tmp_path):
    """A port ModelServer's /metrics (remote tier on, pages in the store):
    both routers read the same signals, ``kv_pages_remote`` included."""
    from kubeflow_tpu_torch.core.serving import BatchingSpec
    from kubeflow_tpu_torch.models.config import preset
    from kubeflow_tpu_torch.serve.engine import LLMEngine, SamplingParams
    from kubeflow_tpu_torch.serve.server import serving_metrics_registry

    eng = LLMEngine(preset("tiny", vocab_size=512, dtype="float32"),
                    BatchingSpec(max_batch_size=2, max_seq_len=96,
                                 paged=True, page_size=16,
                                 chunked_prefill_tokens=16, host_kv_pages=8,
                                 kv_demote_after_s=60.0,
                                 remote_kv_root=str(tmp_path)),
                    seed=0, device="cpu")
    try:
        eng.generate(list(range(1, 40)), SamplingParams(max_new_tokens=2))
        assert eng.drain_kv_to_remote() == 2
        text = serving_metrics_registry([("m", eng)]).render()
    finally:
        eng.stop()
    got = trouter.Router._parse_signals(text)
    assert got == jrouter.Router._parse_signals(text)
    assert got["kv_pages_remote"] == 2


def test_pool_picks_and_alternates_equal_the_jax_router(monkeypatch):
    (jr, tr), clock = _routers(monkeypatch, eject_threshold=2,
                               eject_period=1.0)
    try:
        pools = {"prefill": URLS[:2], "decode": URLS[2:5],
                 "unified": URLS[5:]}
        signals = {URLS[0]: {"pending_prefill_tokens": 300, "in_flight": 1},
                   URLS[1]: {"pending_prefill_tokens": 300, "in_flight": 0},
                   URLS[2]: {"kv_pages_resident": 5, "kv_pages_cached": 1},
                   URLS[3]: {"kv_pages_resident": 5, "kv_pages_cached": 9},
                   URLS[4]: {"kv_pages_resident": 2, "in_flight": 4}}

        def run(r):
            r.set_pools(pools, scrape=False)
            for u, sig in signals.items():
                r.note_signals(u, sig)
            log = []
            for i in range(12):
                excl = frozenset([URLS[4]]) if i % 3 == 0 else frozenset()
                aff = None if i % 2 else f"session-{i % 4}"
                p, d = r.pick_disaggregated(excl, affinity=aff)
                log.append((p, d, r.decode_alternates(d, excl)))
                if i == 5:                      # eject a decode member
                    r.note_backend_failure(URLS[2], connect=True)
                    r.note_backend_failure(URLS[2], connect=True)
                if i == 8:                      # and both prefills
                    for u in URLS[:2]:
                        r.note_backend_failure(u)
                        r.note_backend_failure(u)
            clock.t += 2.0                      # ejections expire
            log.append(r.pick_disaggregated())
            for u in URLS:
                r.note_backend_failure(u)
                r.note_backend_failure(u)
            log.append(r.pick_disaggregated())  # all ejected: panic
            snap = {k: v for k, v in r.snapshot().items()}
            return log, snap

        jlog, jsnap = run(jr)
        tlog, tsnap = run(tr)
        assert tlog == jlog
        assert tsnap == jsnap
        assert tsnap["affinity_hits"] > 0 and tsnap["disagg_fallbacks"] > 0
        assert tsnap["panic_picks"] == 1
    finally:
        jr.httpd.server_close()
        tr.httpd.server_close()


def test_ejection_half_open_panic_timeline_equals_the_jax_router(
        monkeypatch):
    """One group of three backends under one fake clock: consecutive
    failures eject, the window's end makes the next pick a half-open probe
    that re-arms the window, a success reinstates, everything ejected
    panic-routes to the least recently ejected, draining skips."""
    (jr, tr), clock = _routers(monkeypatch, eject_threshold=2,
                               eject_period=5.0)
    a, b, c = URLS[:3]
    try:
        def run(r):
            r.set_backends({"latest": [a, b, c]})
            log = []

            def picks(n=3):
                log.append([r.pick() for _ in range(n)])
                log.append(dict(r.snapshot()))

            picks()
            r.note_backend_failure(a, connect=True)
            picks()                                   # one failure: in
            r.note_backend_failure(a, connect=True)   # second: ejected
            picks(4)
            clock.t += 6.0                            # window over
            picks(4)                                  # a is the probe
            r.note_backend_success(a)                 # probe succeeded
            picks()
            clock.t += 1.0
            r.note_backend_failure(b)
            r.note_backend_failure(b)
            clock.t += 1.0
            r.note_backend_failure(c)
            r.note_backend_failure(c)
            clock.t += 1.0
            r.note_backend_failure(a)
            r.note_backend_failure(a)
            picks(2)                                  # panic: b first
            r.set_draining(b)
            picks(2)                                  # panic skips b
            r.set_draining(b, False)
            log.append(r.pick(exclude=frozenset([a, b, c])))
            return log

        want = run(jr)
        got = run(tr)
        assert got == want
        final = got[-2]
        assert final["ejections"] == 4 and final["half_open_probes"] >= 1
        assert final["panic_picks"] == 4 and got[-1] is None
    finally:
        jr.httpd.server_close()
        tr.httpd.server_close()


def test_parked_request_wakes_on_set_backends():
    """No backend: ``pick_or_wait`` parks (the ``pending`` gauge rises)
    until ``set_backends`` registers one; a request through the HTTP proxy
    parks the same way and is then answered."""
    r = trouter.Router(queue_timeout=10.0)
    r.start()
    echo = EchoBackend("late")
    try:
        got = {}
        t = threading.Thread(target=lambda: got.update(
            pick=r.pick_or_wait(timeout=10.0)))
        t.start()

        def http_call():
            req = urllib.request.Request(r.url + "/v1/echo", data=b"{}")
            with urllib.request.urlopen(req, timeout=15) as resp:
                got["http"] = (resp.status, json.loads(resp.read()))

        h = threading.Thread(target=http_call)
        h.start()
        deadline = time.monotonic() + 5.0
        while r.pending < 2:
            assert time.monotonic() < deadline, r.pending
            time.sleep(0.01)
        assert "pick" not in got
        r.set_backends({"latest": [echo.url]})
        t.join(timeout=5.0)
        h.join(timeout=10.0)
        assert not t.is_alive() and not h.is_alive()
        assert got["pick"] == echo.url
        assert got["http"] == (200, {"backend": "late"})
        assert r.pending == 0
        # With the rotation empty again, the queue timeout answers 503.
        r.set_backends({})
        assert r.pick_or_wait(timeout=0.05) is None
    finally:
        r.stop()
        echo.stop()


def test_retry_and_deadline_restamp_through_a_port_model_server():
    """A dead backend beside a real port ModelServer: every request
    answers 200 through a connect-failure retry, and the engine's deadline
    is the router's remaining budget (capped by ``upstream_timeout``), not
    the client's larger one."""
    from kubeflow_tpu_torch.core.serving import BatchingSpec
    from kubeflow_tpu_torch.models.config import preset
    from kubeflow_tpu_torch.serve.engine import LLMEngine
    from kubeflow_tpu_torch.serve.server import ModelServer

    eng = LLMEngine(preset("tiny", vocab_size=512, dtype="float32"),
                    BatchingSpec(max_batch_size=2, max_seq_len=96,
                                 prefill_buckets=[32]), seed=0, device="cpu")
    seen = []
    submit = eng.submit

    def recording_submit(*a, deadline=None, **kw):
        seen.append(deadline - time.monotonic())
        return submit(*a, deadline=deadline, **kw)

    eng.submit = recording_submit
    srv = ModelServer("tiny", eng)
    srv.start()
    r = trouter.Router(queue_timeout=5.0, eject_threshold=5,
                       max_retries=2, upstream_timeout=8.0)
    r.set_backends({"latest": [dead_url(), srv.url]})
    r.start()
    try:
        for _ in range(3):
            body = json.dumps({"prompt": "retry me", "max_tokens": 4})
            req = urllib.request.Request(
                r.url + "/v1/completions", data=body.encode(),
                headers={"Content-Type": "application/json",
                         trouter.DEADLINE_HEADER: "60000"})
            with urllib.request.urlopen(req, timeout=30) as resp:
                assert resp.status == 200
                assert json.loads(resp.read())["choices"][0]["text"]
        snap = r.snapshot()
        assert snap["connect_failures"] >= 1 and snap["retries"] >= 1
        assert len(seen) == 3
        assert all(0 < s <= 8.0 for s in seen), seen
    finally:
        r.stop()
        srv.stop()


def test_one_trace_from_router_to_engine_and_the_debug_routes():
    """A request through the router and a port ModelServer is one trace
    (router.request → server.request → engine spans), visible on the
    router's and the server's ``/debug/traces`` (with the phase rollup,
    ``?slowest``, ``?chrome=1``) and span exports; the router's own
    ``/metrics`` parses and counts the pick."""
    from kubeflow_tpu_torch.core.serving import BatchingSpec
    from kubeflow_tpu_torch.models.config import preset
    from kubeflow_tpu_torch.obs.fleet import (
        ROUTER_SPANS_EXPORT_PATH, SPANS_EXPORT_PATH,
    )
    from kubeflow_tpu_torch.obs.registry import parse_exposition
    from kubeflow_tpu_torch.obs.trace import get_tracer
    from kubeflow_tpu_torch.serve.engine import LLMEngine
    from kubeflow_tpu_torch.serve.server import ModelServer

    def get(url):
        with urllib.request.urlopen(url, timeout=10) as resp:
            body = resp.read()
        return body if url.endswith(trouter.ROUTER_METRICS_PATH) \
            else json.loads(body)

    eng = LLMEngine(preset("tiny", vocab_size=512, dtype="float32"),
                    BatchingSpec(max_batch_size=2, max_seq_len=96,
                                 prefill_buckets=[32]), seed=0, device="cpu")
    srv = ModelServer("tiny", eng)
    srv.start()
    r = trouter.Router()
    r.set_backends({"latest": [srv.url]})
    r.start()
    try:
        req = urllib.request.Request(
            r.url + "/v1/completions",
            data=json.dumps({"prompt": "trace me", "max_tokens": 3}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=30) as resp:
            assert resp.status == 200
        roots = [t for t in get(r.url + trouter.ROUTER_TRACES_PATH)["traces"]
                 if t["root"] and t["root"]["name"] == "router.request"]
        tid = roots[0]["trace_id"]
        deadline = time.monotonic() + 10.0
        while get_tracer().open_spans(tid):
            assert time.monotonic() < deadline
            time.sleep(0.01)
        trace = next(t for t in get(srv.url + "/debug/traces")["traces"]
                     if t["trace_id"] == tid)
        names = {s["name"] for s in trace["spans"]}
        assert {"router.request", "server.request", "engine.queued",
                "engine.prefill"} <= names, names
        assert {s["trace_id"] for s in trace["spans"]} == {tid}
        assert "prefill_ms" in trace["phases"]
        assert len(get(srv.url + "/debug/traces?slowest=1")["traces"]) == 1
        chrome = get(srv.url + "/debug/traces?chrome=1")
        assert any(e["ph"] == "X" and e["name"] == "server.request"
                   for e in chrome["traceEvents"])
        export = get(srv.url + SPANS_EXPORT_PATH)
        assert export["process"]["name"] == "server:tiny"
        assert any(s["trace_id"] == tid for s in export["spans"])
        assert get(r.url + ROUTER_SPANS_EXPORT_PATH)["process"]["name"] == \
            "router"
        metrics = {n: v for n, _, v in parse_exposition(
            get(r.url + trouter.ROUTER_METRICS_PATH).decode())}
        assert metrics["kftpu_router_picks"] >= 1
        assert metrics["kftpu_router_backends"] == 1
    finally:
        r.stop()
        srv.stop()
