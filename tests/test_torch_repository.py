"""The port's model repository (``serve/repository.py``) behind its
ModelServer on the CPU, held to the JAX package's:

- ``estimate_model_bytes``: the same integer as the JAX function for fp32,
  bf16, int8-pool and LoRA batchings (exact);
- the repository cases of tests/test_serve_server.py through the port:
  the v2 index, lazy load, explicit load and unload, LRU eviction with
  ``max_loaded=1``, the OpenAI model field, 404 for an unknown model,
  per-model /metrics, and 400 on a single-model server; an unload while a
  request holds a lease lets it finish 200 and stops the engine after;
- greedy text of a repository server over two models equals the JAX
  repository server's on the same (converted) weights (exact, fp32)."""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from kubeflow_tpu.core.serving import BatchingSpec as JBatchingSpec  # noqa: E402
from kubeflow_tpu.core.serving import LoRASpec as JLoRASpec  # noqa: E402
from kubeflow_tpu.models import config as jconfig  # noqa: E402
from kubeflow_tpu.models.decoder import init_decoder_params  # noqa: E402
from kubeflow_tpu.serve import engine as jengine  # noqa: E402
from kubeflow_tpu.serve import repository as jrepo  # noqa: E402
from kubeflow_tpu.serve import server as jserver  # noqa: E402
from kubeflow_tpu_torch.core.serving import BatchingSpec, LoRASpec  # noqa: E402
from kubeflow_tpu_torch.models import config as tconfig  # noqa: E402
from kubeflow_tpu_torch.models.convert import params_from_jax  # noqa: E402
from kubeflow_tpu_torch.serve.engine import LLMEngine  # noqa: E402
from kubeflow_tpu_torch.serve.repository import (  # noqa: E402
    ModelRepository, estimate_model_bytes,
)
from kubeflow_tpu_torch.serve.server import ModelServer  # noqa: E402
from port_threads import torch_on_one_thread  # noqa: E402,F401

SPEC = dict(max_batch_size=2, max_seq_len=64, prefill_buckets=[16])
MODELS = {"alpha": ("tiny", 0), "beta": ("tiny-gemma", 1)}


def http(server, method: str, path: str, body: dict | None = None):
    """(status, parsed-json-or-text) without raising on 4xx/5xx."""
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(server.url + path, data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            raw, code = r.read(), r.status
            ctype = r.headers.get("Content-Type", "")
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")
    return code, (json.loads(raw) if "json" in ctype else raw.decode())


def _states(server) -> dict:
    return {m["name"]: m["state"]
            for m in http(server, "GET", "/v2/repository/index")[1]["models"]}


@pytest.fixture(scope="module")
def weights():
    """name -> (JAX config, JAX params, port config, port params)."""
    out = {}
    for name, (pre, seed) in MODELS.items():
        jcfg = jconfig.preset(pre, vocab_size=512, dtype="float32")
        jp = init_decoder_params(jax.random.PRNGKey(seed), jcfg)
        tcfg = tconfig.preset(pre, vocab_size=512, dtype="float32")
        out[name] = (jcfg, jp, tcfg, params_from_jax(
            jax.tree.map(np.asarray, jp), device="cpu"))
    return out


def _port_repo(weights, max_loaded=1, make=None) -> ModelRepository:
    repo = ModelRepository(max_loaded=max_loaded, device="cpu")
    for name, (_, _, tcfg, tp) in weights.items():
        spec = BatchingSpec(**SPEC)

        def build(tcfg=tcfg, tp=tp, spec=spec):
            eng = LLMEngine(tcfg, spec, params=tp, device="cpu")
            return make(eng) if make is not None else eng

        repo.register(name, tcfg, make_engine=build, batching=spec)
    return repo


@pytest.fixture()
def repo_server(weights):
    srv = ModelServer("alpha", repository=_port_repo(weights))
    srv.start()
    yield srv
    srv.stop()


@pytest.mark.parametrize("case", ["fp32", "bf16", "int8", "lora", "none"])
def test_estimate_model_bytes_matches_jax(case):
    over = {"fp32": {}, "bf16": {"param_dtype": "bfloat16"},
            "int8": {"param_dtype": "bfloat16"},
            "lora": {"param_dtype": "bfloat16"}, "none": {}}[case]
    batch = {"fp32": dict(max_batch_size=8, max_seq_len=2048),
             "bf16": dict(max_batch_size=8, max_seq_len=2048),
             "int8": dict(max_batch_size=8, max_seq_len=2048, paged=True,
                          kv_cache_dtype="int8"),
             "lora": dict(max_batch_size=4, max_seq_len=1024)}.get(case)
    jcfg = jconfig.preset("llama3-8b", **over)
    tcfg = tconfig.preset("llama3-8b", **over)
    if batch is None:
        jb = tb = None
    elif case == "lora":
        lora = dict(max_adapters=4, rank=16, targets=("wq", "wk", "wv", "wo"))
        jb = JBatchingSpec(**batch, lora=JLoRASpec(**lora))
        tb = BatchingSpec(**batch, lora=LoRASpec(**lora))
    else:
        jb, tb = JBatchingSpec(**batch), BatchingSpec(**batch)
    want = jrepo.estimate_model_bytes(jcfg, jb)
    assert estimate_model_bytes(tcfg, tb) == want
    if case == "lora":
        # The packed buffers: 4 slots x 32 layers x rank 16 x (8192 + 5120 +
        # 5120 + 8192) x 2 B, on top of the LoRA-free estimate.
        assert want - jrepo.estimate_model_bytes(
            jcfg, JBatchingSpec(**batch)) == 109_051_904


def test_estimate_prices_weight_quantization():
    # int8 weights are served now: the estimate prices them packed, as the
    # JAX package's does (tests/test_torch_quantization.py covers more).
    spec = dict(max_batch_size=2, max_seq_len=64, quantize="int8")
    for name in ("tiny", "tiny-moe"):
        assert estimate_model_bytes(
            tconfig.preset(name), BatchingSpec(**spec)) == \
            jrepo.estimate_model_bytes(jconfig.preset(name),
                                       JBatchingSpec(**spec))


def test_index_and_lazy_load(repo_server):
    code, out = http(repo_server, "GET", "/v2/repository/index")
    assert code == 200
    assert {m["name"]: m["state"] for m in out["models"]} == \
        {"alpha": "UNLOADED", "beta": "UNLOADED"}
    code, out = http(repo_server, "POST", "/v1/models/alpha:predict",
                     {"instances": ["hi"], "max_tokens": 4})
    assert code == 200 and len(out["predictions"]) == 1
    assert _states(repo_server)["alpha"] == "READY"
    # Recency order (the LRU's): the model just served comes last.
    assert http(repo_server, "GET", "/v1/models")[1] == \
        {"models": ["beta", "alpha"]}


def test_lru_eviction_on_second_model(repo_server):
    http(repo_server, "POST", "/v1/models/alpha:predict",
         {"instances": ["hi"], "max_tokens": 4})
    alpha = repo_server.repository.peek("alpha").engine
    code, _ = http(repo_server, "POST", "/v1/models/beta:predict",
                   {"instances": ["yo"], "max_tokens": 4})
    assert code == 200
    assert _states(repo_server) == {"alpha": "UNLOADED", "beta": "READY"}
    assert alpha.stopped_clean is True       # the evicted engine stopped
    code, _ = http(repo_server, "POST", "/v1/models/alpha:predict",
                   {"instances": ["back"], "max_tokens": 4})
    assert code == 200
    assert _states(repo_server) == {"alpha": "READY", "beta": "UNLOADED"}


def test_explicit_load_unload(repo_server):
    code, out = http(repo_server, "POST", "/v2/repository/models/beta/load",
                     {})
    assert code == 200 and out == {"name": "beta", "state": "READY"}
    code, out = http(repo_server, "POST",
                     "/v2/repository/models/beta/unload", {})
    assert code == 200 and out == {"name": "beta", "state": "UNLOADED"}
    assert http(repo_server, "POST", "/v2/repository/models/nope/load",
                {})[0] == 404
    assert http(repo_server, "POST", "/v2/repository/models/nope/unload",
                {})[0] == 404


def test_openai_model_field_routes_and_unknown_404(repo_server):
    code, out = http(repo_server, "POST", "/v1/completions",
                     {"model": "beta", "prompt": "hello", "max_tokens": 4})
    assert code == 200 and out["model"] == "beta"
    assert _states(repo_server)["beta"] == "READY"
    assert http(repo_server, "POST", "/v1/models/ghost:predict",
                {"instances": ["x"]})[0] == 404
    assert http(repo_server, "POST", "/v1/completions",
                {"model": "ghost", "prompt": "x"})[0] == 404
    assert http(repo_server, "GET", "/v2/models/ghost")[0] == 404
    # Metadata does not load: alpha stays as it was.
    code, meta = http(repo_server, "GET", "/v2/models/alpha")
    assert code == 200 and meta["config"]["vocab_size"] == 512


def test_metrics_labeled_per_model(repo_server):
    http(repo_server, "POST", "/v1/models/alpha:predict",
         {"instances": ["hi"], "max_tokens": 4})
    code, text = http(repo_server, "GET", "/metrics")
    assert 'kftpu_serving_requests_total{model="alpha"}' in text
    assert 'model="beta"' not in text        # a scrape loads nothing


def test_single_model_server_repository_routes(weights):
    """A single-model server: one READY model in the index, 400 for the
    actions, exactly one of engine= or repository= at construction."""
    _, _, tcfg, tp = weights["alpha"]
    eng = LLMEngine(tcfg, BatchingSpec(**SPEC), params=tp, device="cpu")
    with pytest.raises(ValueError, match="exactly one"):
        ModelServer("alpha")
    with pytest.raises(ValueError, match="exactly one"):
        ModelServer("alpha", eng, repository=ModelRepository(device="cpu"))
    srv = ModelServer("alpha", eng)
    srv.start()
    try:
        assert http(srv, "POST", "/v2/repository/models/alpha/load",
                    {})[0] == 400
        assert http(srv, "GET", "/v2/repository/index")[1] == \
            {"models": [{"name": "alpha", "state": "READY"}]}
    finally:
        srv.stop()


def test_leased_unload_drains(weights):
    """An unload while a request holds a lease detaches the engine at once
    (the index says UNLOADED), lets the request finish 200, and stops the
    engine when the lease releases."""
    gate, held = threading.Event(), threading.Event()

    def gated(eng):
        dispatch = eng._dispatch_round

        def run(active):
            held.set()
            assert gate.wait(timeout=60)
            return dispatch(active)

        eng._dispatch_round = run
        return eng

    srv = ModelServer("alpha", repository=_port_repo(weights, make=gated))
    srv.start()
    try:
        reply = []
        th = threading.Thread(target=lambda: reply.append(http(
            srv, "POST", "/v1/completions",
            {"model": "alpha", "prompt": "drain me", "max_tokens": 4})))
        th.start()
        assert held.wait(timeout=60)
        entry = srv.repository.peek("alpha")
        engine = entry.engine
        assert entry.refs == 1
        code, out = http(srv, "POST", "/v2/repository/models/alpha/unload",
                         {})
        assert code == 200 and out["state"] == "UNLOADED"
        assert _states(srv)["alpha"] == "UNLOADED"
        assert entry.draining == [engine] and engine.stopped_clean is None
        gate.set()
        th.join(timeout=60)
        assert reply and reply[0][0] == 200
        assert reply[0][1]["choices"][0]["finish_reason"] == "length"
        deadline = time.monotonic() + 30
        while entry.draining and time.monotonic() < deadline:
            time.sleep(0.01)
        assert entry.draining == [] and entry.refs == 0
        assert engine.stopped_clean is True
    finally:
        gate.set()
        srv.stop()


def test_tokens_equal_the_jax_repository_server(weights):
    """Greedy completions through both repositories (alpha, beta, alpha
    again after the LRU evicted it) on the same weights: the same text."""
    jr = jrepo.ModelRepository(max_loaded=1)
    for name, (jcfg, jp, _, _) in weights.items():
        jr.register(name, jcfg, make_engine=lambda jcfg=jcfg, jp=jp:
                    jengine.LLMEngine(jcfg, JBatchingSpec(**SPEC), params=jp))
    jsrv = jserver.ModelServer("alpha", repository=jr)
    tsrv = ModelServer("alpha", repository=_port_repo(weights))
    jsrv.start()
    tsrv.start()
    try:
        for name in ("alpha", "beta", "alpha"):
            body = {"model": name, "prompt": f"hello {name}",
                    "max_tokens": 8}
            got = http(tsrv, "POST", "/v1/completions", body)
            want = http(jsrv, "POST", "/v1/completions", body)
            assert got[0] == want[0] == 200
            assert got[1]["choices"][0]["text"] == \
                want[1]["choices"][0]["text"], name
            assert _states(tsrv) == _states(jsrv)
    finally:
        jsrv.stop()
        tsrv.stop()
