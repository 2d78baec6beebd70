"""The tensor-parallel serving engine on an MoE model, on the CPU: a 2-rank
gloo gang of ``runtime.worker_main`` runs ``tests/dist_support.py``'s
``tp_engine_suite`` over JAX-initialised ``tiny-moe`` weights (fp32, every
expert's columns split over ``{model: 2}``): the contiguous cache, the page
pool with prefix reuse and a copy-on-write tail, int8 pages and int8
weights, each greedy and sampled (seed 3). Prefill runs the dispatch path
one request at a time with its bucket's pads masked; decode the dense path.

- Greedy tokens equal JAX's ``LLMEngine(mesh=build_mesh({"model": 2}))``
  on every layout, and the port's one-process engine's.
- Sampled tokens equal the one-process engine's with the same seed, and
  every rank ends in the leader's generator state.
- The follower ran exactly the ops the leader dispatched, by name.
- A 2-process ``model_server`` gang (``parallelism {model: 2}``) serving a
  port checkpoint through ``file://`` (each rank reads its slices)
  answers ``/v1/completions`` with the JAX TP engine's tokens; SIGTERM
  ends the leader with 143 and the follower with 0.
- A serving mesh with an ``expert`` axis still raises.
"""

import json
import signal
import time
import urllib.request

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from dist_support import (  # noqa: E402
    TP_ENGINE_CASES, TP_PROMPTS, finish, free_port, spawn_gang,
    tp_generate,
)
from kubeflow_tpu.core.serving import BatchingSpec as JBatchingSpec  # noqa: E402
from kubeflow_tpu.models import config as jconfig  # noqa: E402
from kubeflow_tpu.models import decoder as jdec  # noqa: E402
from kubeflow_tpu.runtime.mesh import build_mesh as jax_mesh  # noqa: E402
from kubeflow_tpu.serve import engine as jengine  # noqa: E402
from kubeflow_tpu_torch.core.serving import BatchingSpec  # noqa: E402
from kubeflow_tpu_torch.models.config import preset  # noqa: E402
from kubeflow_tpu_torch.models.convert import params_from_jax  # noqa: E402
from kubeflow_tpu_torch.serve.engine import LLMEngine  # noqa: E402
from kubeflow_tpu_torch.train.checkpoint import CheckpointManager  # noqa: E402
from port_threads import torch_on_one_thread  # noqa: E402,F401

MODEL = "tiny-moe"
WORLD = 2
CASES = list(TP_ENGINE_CASES)


def _jax_params():
    """JAX's init of the served weights (jitted: one compile instead of
    an op-by-op run; the same values)."""
    return jax.jit(jdec.init_decoder_params, static_argnums=1)(
        jax.random.PRNGKey(5), jconfig.preset(MODEL, dtype="float32"))


def _jax_tp_tokens(jparams, case: str) -> list:
    spec = dict(TP_ENGINE_CASES[case])
    spec.pop("prefill_buckets", None)
    eng = jengine.LLMEngine(
        jconfig.preset(MODEL, dtype="float32"),
        JBatchingSpec(prefill_buckets=[16, 32], **spec), params=jparams,
        mesh=jax_mesh({"model": WORLD}, jax.devices()[:WORLD]))
    return [eng.generate(p, jengine.SamplingParams(max_new_tokens=10))
            for p in TP_PROMPTS]


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """The gang's records, the one-process engine's completions and JAX's
    TP engine's greedy ones on the same weights."""
    base = tmp_path_factory.mktemp("tp_moe_engine")
    jparams = _jax_params()
    params = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    torch.save(params, base / "params.pt")
    procs = spawn_gang(
        "dist_support:tp_engine_suite",
        {"params": str(base / "params.pt"), "out": str(base),
         "model": MODEL},
        WORLD, [base / f"w{r}" for r in range(WORLD)],
        parallelism={"model": WORLD})
    try:
        cfg = preset(MODEL, dtype="float32")
        one = {name: tp_generate(LLMEngine(
            cfg, BatchingSpec(**spec), params=params, device="cpu",
            seed=3)) for name, spec in TP_ENGINE_CASES.items()}
        jax_tokens = {c: _jax_tp_tokens(jparams, c) for c in CASES}
    finally:
        res = finish(procs)
    for r, (rc, _, err) in enumerate(res):
        assert rc == 0, f"rank {r} exit {rc}:\n{err[-4000:]}"
    ranks = [torch.load(base / f"rank{r}.pt", weights_only=False)
             for r in range(WORLD)]
    return {"ranks": ranks, "one": one, "jax": jax_tokens,
            "params": params}


@pytest.mark.parametrize("case", CASES)
def test_greedy_tokens_match_the_one_process_engine_and_jax(served, case):
    got = served["ranks"][0][case]["tokens"][0.0]
    assert got == served["one"][case][0.0]
    assert got == served["jax"][case]


@pytest.mark.parametrize("case", CASES)
def test_sampled_tokens_and_generators_agree_across_ranks(served, case):
    recs = [r[case] for r in served["ranks"]]
    assert recs[0]["tokens"][0.8] == served["one"][case][0.8]
    assert recs[0]["tokens"][0.8] != recs[0]["tokens"][0.0]
    for rec in recs[1:]:
        assert torch.equal(rec["gen"], recs[0]["gen"])


@pytest.mark.parametrize("case", CASES)
def test_follower_runs_every_op_the_leader_dispatched(served, case):
    recs = [r[case] for r in served["ranks"]]
    assert recs[0]["ops"] > 0
    for rec in recs[1:]:
        assert rec["ops"] == recs[0]["ops"]
        assert rec["by_op"] == recs[0]["by_op"]
    by_op = recs[0]["by_op"]
    if case.startswith("paged"):
        tier = recs[0]["kv_tier"]
        assert tier["prefix_hits"] > 0 and by_op["copy_pages"] > 0, tier
        assert by_op["paged_chunk_prefill"] > 0
        assert by_op["paged_decode_multi"] > 0
    else:
        # The dispatch prefill takes one request at a time.
        assert by_op["_prefill_step"] == len(TP_PROMPTS) * 2
        assert by_op["_decode_multi"] > 0


def test_unpacked_int8_shards_are_refused(served):
    for rec in served["ranks"]:
        assert "is not packed" in rec["unpacked"]


def test_an_expert_axis_in_serving_raises():
    """A serving mesh holds the model axis alone: ``expert`` (like any
    other axis) raises with its ROADMAP pointer before any rank is
    touched."""
    with pytest.raises(NotImplementedError, match="Queue 1 item 9e"):
        LLMEngine(preset(MODEL, dtype="float32"),
                  BatchingSpec(**TP_ENGINE_CASES["contiguous"]),
                  device="cpu", mesh={"expert": 2, "model": 2})


def _post(url: str, body: dict) -> dict:
    req = urllib.request.Request(url, json.dumps(body).encode(),
                                 {"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return json.loads(resp.read())


def test_model_server_gang_serves_the_jax_tp_engines_tokens(served,
                                                             tmp_path):
    ckpt = tmp_path / "ckpt"
    mgr = CheckpointManager(str(ckpt))
    mgr.save(1, {"params": served["params"]})
    mgr.wait()
    port = free_port()
    conf = {"model": {"preset": MODEL, "overrides": {"dtype": "float32"}},
            "storage_uri": f"file://{ckpt}",
            "batching": dict(TP_ENGINE_CASES["contiguous"]), "port": port,
            "service": "tiny-moe", "tokenizer": "dist_support:IdText"}
    procs = spawn_gang("model_server", conf, WORLD,
                       [tmp_path / "w0", tmp_path / "w1"],
                       parallelism={"model": WORLD})
    try:
        got, t0 = None, time.monotonic()
        while got is None and time.monotonic() - t0 < 120:
            try:
                got = [_post(f"http://127.0.0.1:{port}/v1/completions",
                             {"prompt": " ".join(map(str, p)),
                              "max_tokens": 10, "temperature": 0})
                       for p in TP_PROMPTS]
            except OSError:
                assert all(p.poll() is None for p in procs)
                time.sleep(0.3)
        procs[0].send_signal(signal.SIGTERM)
    finally:
        res = finish(procs, timeout=60)
    tokens = [[int(x) for x in o["choices"][0]["text"].split()] for o in got]
    assert tokens == served["jax"]["contiguous"]
    assert [rc for rc, _, _ in res] == [143, 0], [e[-2000:] for *_, e in res]
