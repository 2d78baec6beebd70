"""The port's ModelServer over HTTP on the CPU: every route this slice
serves, the OpenAI stream, error mapping, and /metrics — whose series names
must equal the JAX package's ``serving_metrics_registry`` for a fresh
engine, so loadgen, router and autoscaler scrapes read a port replica
unchanged. The copied wire constants (headers, tokenizer) are held to the
JAX package's."""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from kubeflow_tpu.core import headers as jheaders  # noqa: E402
from kubeflow_tpu.core.serving import BatchingSpec as JBatchingSpec  # noqa: E402
from kubeflow_tpu.models import config as jconfig  # noqa: E402
from kubeflow_tpu.serve import engine as jengine  # noqa: E402
from kubeflow_tpu.serve import server as jserver  # noqa: E402
from kubeflow_tpu.serve import tokenizer as jtok  # noqa: E402
from kubeflow_tpu_torch.core import headers as theaders  # noqa: E402
from kubeflow_tpu_torch.core.serving import BatchingSpec  # noqa: E402
from kubeflow_tpu_torch.models.config import preset  # noqa: E402
from kubeflow_tpu_torch.obs.registry import parse_exposition  # noqa: E402
from kubeflow_tpu_torch.serve import tokenizer as ttok  # noqa: E402
from kubeflow_tpu_torch.serve.engine import (  # noqa: E402
    HOST_GAP_BUCKETS, QUEUE_DELAY_BUCKETS, LLMEngine,
)
from kubeflow_tpu_torch.serve.server import (  # noqa: E402
    ModelServer, serving_metrics_registry,
)
from port_threads import torch_on_one_thread  # noqa: E402,F401

SPEC = dict(max_batch_size=4, max_seq_len=128, prefill_buckets=[32, 64, 128])


def _engine():
    # vocab 512 covers the byte tokenizer's 259 ids.
    return LLMEngine(preset("tiny", vocab_size=512, dtype="float32"),
                     BatchingSpec(**SPEC), device="cpu")


@pytest.fixture(scope="module")
def server():
    srv = ModelServer("tiny", _engine())
    srv.start()
    yield srv
    srv.stop()


def _post(srv, path, body, headers=None):
    req = urllib.request.Request(
        srv.url + path, data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _post_raw(srv, path, data: bytes, headers=None):
    req = urllib.request.Request(
        srv.url + path, data=data,
        headers={"Content-Type": "application/octet-stream",
                 **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _get(srv, path):
    with urllib.request.urlopen(srv.url + path, timeout=60) as r:
        return r.status, r.read()


def test_health_and_model_routes(server):
    for path in ("/healthz", "/v2/health/ready", "/v2/health/live"):
        status, body = _get(server, path)
        assert status == 200 and json.loads(body)["status"] == "ok"
    assert json.loads(_get(server, "/v1/models")[1]) == {"models": ["tiny"]}
    meta = json.loads(_get(server, "/v2/models/tiny")[1])
    assert meta["config"] == {"vocab_size": 512, "max_seq_len": 128}


def test_completion_stream_and_predict_agree(server):
    body = {"prompt": "hello world", "max_tokens": 6}
    status, raw = _post(server, "/v1/completions", body)
    assert status == 200
    out = json.loads(raw)
    assert out["object"] == "text_completion"
    assert out["usage"]["prompt_tokens"] == len("hello world") + 1
    assert 1 <= out["usage"]["completion_tokens"] <= 6
    # Greedy: the SSE stream, v1 predict and v2 infer decode the same text.
    status, raw = _post(server, "/v1/completions", {**body, "stream": True})
    assert status == 200
    events = [ln[len("data: "):] for ln in raw.decode().split("\n")
              if ln.startswith("data: ")]
    assert events[-1] == "[DONE]"
    streamed = "".join(json.loads(e)["choices"][0]["text"]
                       for e in events[:-1])
    assert streamed == out["choices"][0]["text"]
    status, raw = _post(server, "/v1/models/tiny:predict",
                        {"instances": ["hello world"], "max_tokens": 6})
    assert status == 200
    assert json.loads(raw)["predictions"] == [out["choices"][0]["text"]]
    status, raw = _post(server, "/v2/models/tiny/infer",
                        {"inputs": [{"name": "text", "datatype": "BYTES",
                                     "shape": [1], "data": ["hello world"]}],
                         "max_tokens": 6})
    assert status == 200
    assert json.loads(raw)["outputs"][0]["data"] == \
        [out["choices"][0]["text"]]


def test_errors_map_to_http_status(server):
    assert _post(server, "/v1/models/other:predict",
                 {"instances": ["x"]})[0] == 404
    assert _post(server, "/v1/models/tiny:predict", {"bad": 1})[0] == 400
    # /v1/handoff without a payload (an empty or a JSON body) is a clean
    # client error, never a 500; a single-model server answers the model
    # repository's routes as the JAX server does (its one model in the
    # index, 400 for a load or an unload); :explain without an explainer
    # hop is a 400.
    assert 400 <= _post_raw(server, "/v1/handoff", b"")[0] < 500
    assert 400 <= _post(server, "/v1/handoff", {})[0] < 500
    jsrv = jserver.ModelServer("tiny", jengine.LLMEngine(
        jconfig.preset("tiny", vocab_size=512), JBatchingSpec(**SPEC)))
    jsrv.start()
    try:
        for path in ("/v2/repository/models/tiny/load",
                     "/v2/repository/models/tiny/unload",
                     "/v2/repository/models/nope/load"):
            got, want = _post(server, path, {}), _post(jsrv, path, {})
            assert got[0] == want[0] == 400, (path, got, want)
            assert json.loads(got[1]) == json.loads(want[1])
        assert json.loads(_get(server, "/v2/repository/index")[1]) == \
            json.loads(_get(jsrv, "/v2/repository/index")[1]) == \
            {"models": [{"name": "tiny", "state": "READY"}]}
    finally:
        jsrv.stop()
    assert _post(server, "/v1/models/tiny:explain",
                 {"instances": ["x"]})[0] == 400
    assert _post(server, "/v1/completions", {"prompt": "x"},
                 {theaders.QOS_HEADER: "platinum"})[0] == 400
    assert _post(server, "/v1/completions",
                 {"prompt": "x" * 200, "max_tokens": 2})[0] == 400
    # A blown deadline header is reaped by the engine: 504, not an empty 200.
    assert _post(server, "/v1/completions", {"prompt": "x", "max_tokens": 4},
                 {theaders.DEADLINE_HEADER: "0"})[0] == 504


def test_metrics_parse_and_count_traffic(server):
    _post(server, "/v1/completions", {"prompt": "abc", "max_tokens": 3})
    status, raw = _get(server, "/metrics")
    assert status == 200
    samples = parse_exposition(raw.decode())
    by_name = {(n, lab.get("model")): v for n, lab, v in samples}
    assert by_name[("kftpu_serving_requests_total", "tiny")] >= 1
    assert by_name[("kftpu_serving_tokens_total", "tiny")] >= 1
    assert ("kftpu_serving_ttft_p50_ms", "tiny") in by_name


def _series(srv, name):
    samples = parse_exposition(_get(srv, "/metrics")[1].decode())
    return next(v for n, lab, v in samples
                if n == name and lab.get("model") == "tiny")


def test_paged_metrics_show_the_real_pool():
    """A paged replica's /metrics reads the page pool: pages resident while
    a request holds them (its decode is held at a gate, so the scrape
    cannot miss them), none after, and the cached prompt pages, prefix
    hits and pool density once a second request shares the prompt."""
    eng = LLMEngine(preset("tiny", vocab_size=512, dtype="float32"),
                    BatchingSpec(**SPEC, paged=True, page_size=16,
                                 chunked_prefill_tokens=32), device="cpu")
    gate, held = threading.Event(), threading.Event()
    dispatch = eng._dispatch_round

    def gated(active):
        held.set()
        assert gate.wait(timeout=60)
        return dispatch(active)

    eng._dispatch_round = gated
    srv = ModelServer("tiny", eng)
    srv.start()
    try:
        body = {"prompt": "a shared prompt of some forty bytes or so",
                "max_tokens": 4}
        reply = []
        th = threading.Thread(target=lambda: reply.append(
            _post(srv, "/v1/completions", body)))
        th.start()
        assert held.wait(timeout=60)
        # 42 prompt tokens (41 bytes and BOS) fill three pages of 16.
        assert _series(srv, "kftpu_engine_kv_pages_resident") == 3
        gate.set()
        th.join(timeout=60)
        assert reply and reply[0][0] == 200
        # The reply can land before the scheduler thread releases the pages
        # (the JAX engine's order too): wait for the release.
        deadline = time.monotonic() + 30
        while _series(srv, "kftpu_engine_kv_pages_resident") and \
                time.monotonic() < deadline:
            time.sleep(0.01)
        assert _series(srv, "kftpu_engine_kv_pages_resident") == 0
        assert _series(srv, "kftpu_engine_kv_pages_cached") >= 2
        again = _post(srv, "/v1/completions", body)
        assert again[0] == 200
        assert json.loads(again[1])["choices"] == \
            json.loads(reply[0][1])["choices"]
        assert _series(srv, "kftpu_engine_kv_prefix_hits_total") == 1
        assert _series(srv, "kftpu_engine_kv_prefix_tokens_reused_total") \
            == 41                            # all but the last prompt token
        assert _series(srv, "kftpu_engine_kv_quant_tokens_per_mib") > 0
    finally:
        gate.set()
        srv.stop()
    eng._allocator.assert_quiescent()


def test_metrics_series_names_match_the_jax_server():
    jeng = jengine.LLMEngine(jconfig.preset("tiny", vocab_size=512),
                             JBatchingSpec(**SPEC))
    want = jserver.serving_metrics_registry([("m", jeng)]).names()
    got = serving_metrics_registry([("m", _engine())]).names()
    assert got == want
    assert jserver.QUEUE_DELAY_BUCKETS == QUEUE_DELAY_BUCKETS
    assert jserver.HOST_GAP_BUCKETS == HOST_GAP_BUCKETS


def test_copied_wire_constants_match_the_jax_package():
    names = [n for n in dir(jheaders) if n.isupper()]
    assert names == [n for n in dir(theaders) if n.isupper()]
    for n in names:
        assert getattr(jheaders, n) == getattr(theaders, n)
    text = "héllo wörld ✓"
    assert ttok.ByteTokenizer().encode(text) == \
        jtok.ByteTokenizer().encode(text)
    corpus = "the cat sat on the mat the cat ate " * 8
    tb, jb = ttok.BPETokenizer.train(corpus, 300), \
        jtok.BPETokenizer.train(corpus, 300)
    assert tb.merges == jb.merges
    ids = tb.encode("the cat sat")
    assert ids == jb.encode("the cat sat") and tb.decode(ids) == "the cat sat"


def test_trace_header_joins_engine_spans(server):
    """A request carrying ``X-Kftpu-Trace`` joins that trace: the server
    span and the engine's queued → prefill → decode spans share its id,
    and nothing is left open."""
    from kubeflow_tpu_torch.obs.trace import get_tracer

    trace_id, parent = "ab" * 16, "cd" * 8
    status, _ = _post(server, "/v1/completions",
                      {"prompt": "trace me", "max_tokens": 3},
                      {theaders.TRACE_HEADER: f"{trace_id}-{parent}"})
    assert status == 200
    # The handler closes its span after it has written the reply, so the
    # client may read the reply first: wait for this trace's own spans to
    # close (other tests' spans in this process are not this test's).
    deadline = time.monotonic() + 10.0
    while get_tracer().open_spans(trace_id) and time.monotonic() < deadline:
        time.sleep(0.01)
    spans = get_tracer().trace(trace_id)["spans"]
    names = [s["name"] for s in spans]
    for name in ("server.request", "engine.queued", "engine.prefill",
                 "engine.decode", "server.detokenize"):
        assert name in names, names
    request = next(s for s in spans if s["name"] == "server.request")
    assert request["parent_id"] == parent
    engine_parents = {s["parent_id"] for s in spans
                      if s["name"].startswith("engine.")}
    assert engine_parents == {request["span_id"]}
    assert get_tracer().open_spans(trace_id) == 0


# -- disaggregated serving: a prefill server relaying to a decode server -------

PAGED = dict(SPEC, paged=True, page_size=16, chunked_prefill_tokens=32)
PROMPT_BODY = {"prompt": "a prompt the prefill replica hands off", "max_tokens": 8}


def _paged_server(role="unified", **kw):
    srv = ModelServer("tiny", LLMEngine(
        preset("tiny", vocab_size=512, dtype="float32"),
        BatchingSpec(**PAGED, role=role, **kw), device="cpu"))
    srv.start()
    return srv


@pytest.fixture(scope="module")
def pair():
    """A unified, a prefill and a decode server on the same weights."""
    servers = {role: _paged_server(role)
               for role in ("unified", "prefill", "decode")}
    yield servers
    for srv in servers.values():
        srv.stop()


def _text(raw: bytes, stream: bool) -> str:
    if not stream:
        return json.loads(raw)["choices"][0]["text"]
    events = [ln[len("data: "):] for ln in raw.decode().split("\n")
              if ln.startswith("data: ")]
    assert events[-1] == "[DONE]"
    return "".join(json.loads(e)["choices"][0]["text"] for e in events[:-1])


def _dead_url() -> str:
    """The URL of a decode server that has stopped."""
    srv = _paged_server("decode")
    srv.stop()
    return srv.url


def _drained(srv) -> None:
    deadline = time.monotonic() + 30
    while (srv.engine.kv_pages_in_use() or srv.engine._handoff_holds) \
            and time.monotonic() < deadline:
        time.sleep(0.01)
    srv.engine._allocator.assert_quiescent()


@pytest.mark.parametrize("stream", [False, True], ids=["json", "sse"])
def test_prefill_server_relays_to_the_decode_server(pair, stream):
    """A prefill-role server given the decode server's URL returns the
    unified server's text; the prefill side exported, the decode side
    adopted, and no page stays held on either."""
    body = {**PROMPT_BODY, "stream": stream}
    status, raw = _post(pair["unified"], "/v1/completions", body)
    assert status == 200
    want = _text(raw, stream)
    pre, dec = pair["prefill"], pair["decode"]
    out0 = pre.engine.metrics.snapshot()["handoffs_exported"]
    in0 = dec.engine.metrics.snapshot()["handoffs_adopted"]
    status, raw = _post(pre, "/v1/completions", body,
                        {theaders.DECODE_BACKEND_HEADER: dec.url})
    assert status == 200
    assert _text(raw, stream) == want
    assert pre.engine.metrics.snapshot()["handoffs_exported"] == out0 + 1
    assert dec.engine.metrics.snapshot()["handoffs_adopted"] == in0 + 1
    # Without the header a prefill replica decodes locally.
    status, raw = _post(pre, "/v1/completions", body)
    assert status == 200 and _text(raw, stream) == want
    assert pre.engine.metrics.snapshot()["handoffs_exported"] == out0 + 1
    _drained(pre)
    _drained(dec)


@pytest.mark.parametrize("stream", [False, True], ids=["json", "sse"])
def test_prefill_server_falls_back_when_the_decode_server_is_gone(stream):
    uni, pre = _paged_server(), _paged_server("prefill")
    try:
        body = {**PROMPT_BODY, "stream": stream}
        want = _text(_post(uni, "/v1/completions", body)[1], stream)
        status, raw = _post(pre, "/v1/completions", body,
                            {theaders.DECODE_BACKEND_HEADER: _dead_url()})
        assert status == 200
        assert _text(raw, stream) == want
        snap = pre.engine.metrics.snapshot()
        assert snap["handoffs_fallback"] == 1
        assert snap["handoffs_failed"] == 1
        assert _series(pre, "kftpu_engine_handoffs_fallback_total") == 1
        _drained(pre)
    finally:
        uni.stop()
        pre.stop()


def test_prefill_server_tries_the_alternate_decode_server(pair):
    pre, dec = pair["prefill"], pair["decode"]
    want = _text(_post(pair["unified"], "/v1/completions", PROMPT_BODY)[1],
                 False)
    before = pre.engine.metrics.snapshot()
    status, raw = _post(pre, "/v1/completions", PROMPT_BODY, {
        theaders.DECODE_BACKEND_HEADER: _dead_url(),
        theaders.DECODE_ALTS_HEADER: dec.url})
    assert status == 200 and _text(raw, False) == want
    snap = pre.engine.metrics.snapshot()
    assert snap["handoffs_retried"] == before["handoffs_retried"] + 1
    assert snap["handoffs_fallback"] == before["handoffs_fallback"]
    assert snap["handoffs_exported"] == before["handoffs_exported"] + 1
    assert _series(pre, "kftpu_engine_handoffs_retried_total") >= 1
    _drained(pre)


def test_handoff_route_refuses_foreign_wire_and_cache_dtype(pair):
    """409 before any page byte is read: a wire version the server does
    not speak, a cache dtype its pool does not store (header), and the
    same mismatch in the payload itself (no headers)."""
    from kubeflow_tpu_torch.serve.handoff import HandoffPayload

    cfg = pair["decode"].engine.cfg
    kv = np.zeros((cfg.n_layers, 3, cfg.n_kv_heads, cfg.head_dim), np.int8)
    sc = np.ones(kv.shape[:-1], np.float32)
    int8_payload = HandoffPayload(
        request_id="h", prompt_tokens=[5, 6, 7], first_token=8,
        max_new_tokens=3, temperature=0.0, top_k=0, top_p=1.0,
        stop_token=None, qos="standard", kv_k=kv, kv_v=kv,
        kv_scale_k=sc, kv_scale_v=sc).to_wire()
    dec = pair["decode"]
    status, raw = _post_raw(dec, "/v1/handoff", int8_payload,
                            {theaders.HANDOFF_WIRE_HEADER: "3"})
    assert status == 409 and b"wire version" in raw
    status, raw = _post_raw(dec, "/v1/handoff", int8_payload,
                            {theaders.HANDOFF_DTYPE_HEADER: "int8",
                             theaders.HANDOFF_WIRE_HEADER: "2"})
    assert status == 409 and b"cache-dtype" in raw
    status, raw = _post_raw(dec, "/v1/handoff", int8_payload)
    assert status == 409 and b"cache-dtype" in raw
    assert dec.engine.queue_depth() == 0


def test_handoff_keeps_one_trace(pair):
    """The prefill server's request, its engine spans, the engine.handoff
    span, and the decode server's adopted queued → decode spans share the
    trace of the caller's header."""
    from kubeflow_tpu_torch.obs.trace import get_tracer

    pre, dec = pair["prefill"], pair["decode"]
    trace_id, parent = "ef" * 16, "12" * 8
    status, _ = _post(pre, "/v1/completions", PROMPT_BODY, {
        theaders.TRACE_HEADER: f"{trace_id}-{parent}",
        theaders.DECODE_BACKEND_HEADER: dec.url})
    assert status == 200
    deadline = time.monotonic() + 10.0
    while get_tracer().open_spans(trace_id) and time.monotonic() < deadline:
        time.sleep(0.01)
    assert get_tracer().open_spans(trace_id) == 0
    spans = get_tracer().trace(trace_id)["spans"]
    names = [s["name"] for s in spans]
    assert names.count("server.request") == 2, names
    assert names.count("engine.queued") == 2, names
    for name in ("engine.prefill", "engine.handoff", "engine.decode"):
        assert names.count(name) == 1, names
    handoff = next(s for s in spans if s["name"] == "engine.handoff")
    assert handoff["attrs"]["backend"] == dec.url
    decode = next(s for s in spans if s["name"] == "engine.decode")
    assert decode["attrs"]["adopted"] is True
    # The decode server's request span hangs off the handoff span.
    remote = next(s for s in spans if s["name"] == "server.request"
                  and s["parent_id"] == handoff["span_id"])
    assert remote["attrs"]["path"] == "/v1/handoff"
    _drained(pre)
