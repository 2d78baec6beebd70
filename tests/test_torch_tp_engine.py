"""The tensor-parallel serving engine on the CPU: gloo gangs of
``runtime.worker_main`` (2 ranks; and 4, where tiny's 2 kv heads are whole
on every rank and each reads its own) run ``tests/dist_support.py``'s
``tp_engine_suite`` over JAX-initialised ``tiny`` weights (fp32): the
contiguous cache, the page pool with prefix reuse and a copy-on-write
tail, int8 pages and int8 weights, each greedy and sampled (seed 3).

- Greedy tokens equal JAX's ``LLMEngine(mesh=build_mesh({"model": 2}))``
  on every layout (its page pool and int8 pages sharded on the kv heads,
  int8 weights as JAX's own test of them) and the port's one-process
  engine's.
- Sampled tokens equal the one-process engine's with the same seed: every
  rank draws from its own generator, in the leader's order, so each ends
  in the leader's generator state.
- The followers ran exactly the ops the leader dispatched, by name.
- An int8-weight engine given shards that are not packed raises.
- A 2-process ``model_server`` gang (``parallelism {model: 2}``) serving a
  port checkpoint through ``file://`` (each rank reads its slices)
  answers ``/v1/completions`` with the JAX TP engine's tokens; SIGTERM
  ends the leader with 143 and the follower with 0.
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

WORLDS = (2, 4)


def _jax_params():
    return jdec.init_decoder_params(jax.random.PRNGKey(5),
                                    jconfig.preset("tiny", dtype="float32"))


def _jax_tp_tokens(jparams, case: str) -> list:
    spec = dict(TP_ENGINE_CASES[case])
    spec.pop("prefill_buckets", None)
    eng = jengine.LLMEngine(
        jconfig.preset("tiny", dtype="float32"),
        JBatchingSpec(prefill_buckets=[16, 32], **spec), params=jparams,
        mesh=jax_mesh({"model": 2}, jax.devices()[:2]))
    return [eng.generate(p, jengine.SamplingParams(max_new_tokens=10))
            for p in TP_PROMPTS]


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """Both gangs' records, the one-process engine's completions and JAX's
    TP engine's greedy ones on the same weights."""
    base = tmp_path_factory.mktemp("tp_engine")
    jparams = _jax_params()
    params = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    torch.save(params, base / "params.pt")
    procs = {}
    for w in WORLDS:
        (base / str(w)).mkdir()
        procs[w] = spawn_gang(
            "dist_support:tp_engine_suite",
            {"params": str(base / "params.pt"), "out": str(base / str(w))},
            w, [base / str(w) / f"w{r}" for r in range(w)],
            parallelism={"model": w})
    try:
        cfg = preset("tiny", dtype="float32")
        one = {name: tp_generate(LLMEngine(
            cfg, BatchingSpec(**spec), params=params, device="cpu",
            seed=3)) for name, spec in TP_ENGINE_CASES.items()}
        jax_tokens = {c: _jax_tp_tokens(jparams, c)
                      for c in TP_ENGINE_CASES}
    finally:
        res = {w: finish(p) for w, p in procs.items()}
    for w, rs in res.items():
        for r, (rc, _, err) in enumerate(rs):
            assert rc == 0, f"world {w} rank {r} exit {rc}:\n{err[-4000:]}"
    ranks = {w: [torch.load(base / str(w) / f"rank{r}.pt",
                            weights_only=False) for r in range(w)]
             for w in WORLDS}
    return {"ranks": ranks, "one": one, "jax": jax_tokens,
            "jparams": jparams, "params": params, "base": base}


CASES = [(w, c) for w in WORLDS for c in TP_ENGINE_CASES]
IDS = [f"{c}-model{w}" for w, c in CASES]


@pytest.mark.parametrize("world,case", CASES, ids=IDS)
def test_greedy_tokens_match_the_one_process_engine_and_jax(served, world,
                                                            case):
    got = served["ranks"][world][0][case]["tokens"][0.0]
    assert got == served["one"][case][0.0]
    assert got == served["jax"][case]


@pytest.mark.parametrize("world,case", CASES, ids=IDS)
def test_sampled_tokens_and_generators_agree_across_ranks(served, world,
                                                          case):
    recs = [r[case] for r in served["ranks"][world]]
    assert recs[0]["tokens"][0.8] == served["one"][case][0.8]
    assert recs[0]["tokens"][0.8] != recs[0]["tokens"][0.0]
    for rec in recs[1:]:
        assert torch.equal(rec["gen"], recs[0]["gen"])


@pytest.mark.parametrize("world,case", CASES, ids=IDS)
def test_followers_run_every_op_the_leader_dispatched(served, world, case):
    recs = [r[case] for r in served["ranks"][world]]
    assert recs[0]["ops"] > 0
    for rec in recs[1:]:
        assert rec["ops"] == recs[0]["ops"]
        assert rec["by_op"] == recs[0]["by_op"]
    by_op = recs[0]["by_op"]
    assert by_op["_sample_batch"] > 0           # first tokens, on every rank
    if case.startswith("paged"):
        tier = recs[0]["kv_tier"]
        assert tier["prefix_hits"] > 0 and by_op["copy_pages"] > 0, tier
        assert by_op["paged_decode_multi"] > 0
    else:
        assert by_op["_decode_multi"] > 0


@pytest.mark.parametrize("world", WORLDS)
def test_unpacked_int8_shards_are_refused(served, world):
    """Under a mesh an int8 engine takes shards packed whole: a shard of a
    row-parallel weight cannot make the whole weight's scales, so shards
    given unpacked raise on every rank before any op is dispatched."""
    for rec in served["ranks"][world]:
        assert "is not packed" in rec["unpacked"]


def test_kv_cache_holds_the_ranks_kv_heads():
    """Under no mesh the cache holds every kv head; the rank's share is
    what ``local_kv_heads`` says: 1 of 2 over model = 2, and the one its
    q head's group reads over model = 4 (kv heads whole on every rank).
    Over model = 3 tiny's 4 heads do not divide: they are whole on every
    rank (as JAX replicates them) and shared along the GQA groups, so
    each rank's q heads read one kv head; 6 heads and 3 kv heads over
    model = 2 split the q heads evenly, and a rank whose heads split a
    group holds one kv head per q head (the engines' tokens against JAX's
    are in tests/test_torch_nondivisible.py)."""
    import dataclasses

    from kubeflow_tpu_torch.models import layers as L
    from kubeflow_tpu_torch.models.config import with_model_axis
    from kubeflow_tpu_torch.parallel.collectives import ModelAxis

    cfg = preset("tiny", dtype="float32")
    assert L.local_kv_heads(cfg) == (0, 1)
    got = [L.local_kv_heads(with_model_axis(cfg, ModelAxis(None, r, n)))
           for n in (2, 4) for r in range(n)]
    assert got == [(0,), (1,), (0,), (0,), (1,), (1,)]
    three = with_model_axis(cfg, ModelAxis(None, 0, 3))
    assert L.head_owners(three) == [(0, 1), (1, 2), (2, 4)]
    assert L.kv_head_owners(three) == [(0,), (0,), (1,)]
    six = with_model_axis(dataclasses.replace(cfg, n_heads=6, n_kv_heads=3),
                          ModelAxis(None, 0, 2))
    assert L.head_owners(six) == [(0, 3), (3, 6)]
    assert L.kv_head_owners(six) == [(0, 0, 1), (1, 2, 2)]


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
    conf = {"model": {"preset": "tiny", "overrides": {"dtype": "float32"}},
            "storage_uri": f"file://{ckpt}",
            "batching": dict(TP_ENGINE_CASES["contiguous"]), "port": port,
            "service": "tiny", "tokenizer": "dist_support:IdText"}
    procs = spawn_gang("model_server", conf, 2,
                       [tmp_path / "w0", tmp_path / "w1"],
                       parallelism={"model": 2})
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


@pytest.mark.parametrize("dead", [1, 0], ids=["follower", "leader"])
def test_a_dead_rank_ends_the_other(tmp_path, dead):
    """A follower SIGKILLed while the leader idles fails the leader's next
    ping; a leader SIGKILLed fails the follower's wait for the next op:
    the survivor exits nonzero within seconds, neither side hangs."""
    port = free_port()
    conf = {"model": {"preset": "tiny", "overrides": {"dtype": "float32"}},
            "storage_uri": "random://",
            "batching": dict(TP_ENGINE_CASES["contiguous"]), "port": port,
            "service": "tiny", "tokenizer": "dist_support:IdText"}
    procs = spawn_gang("model_server", conf, 2,
                       [tmp_path / "w0", tmp_path / "w1"],
                       parallelism={"model": 2})
    try:
        t0 = time.monotonic()
        while time.monotonic() - t0 < 120:
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{port}/v2/health/ready",
                        timeout=2) as resp:
                    if resp.status == 200:
                        break
            except OSError:
                assert all(p.poll() is None for p in procs)
                time.sleep(0.3)
        procs[dead].kill()
        t1 = time.monotonic()
        rc = procs[1 - dead].wait(timeout=30)
        waited = time.monotonic() - t1
    finally:
        res = finish(procs, timeout=30)
    assert rc not in (0, None), res[1 - dead][2][-2000:]
    assert waited < 30
