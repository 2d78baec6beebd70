"""The explainers under a tensor-parallel engine on the CPU, held against
the JAX package's explainers on a ``{model: 2}`` mesh of virtual devices
(``mesh=``, as JAX's ``ModelServer.explain_text`` runs them on a mesh
engine) on the same weights (``params_from_jax``), ``tiny`` and
``tiny-moe`` (the dense path, which the port's server swaps to as JAX's
does):

- a 2-rank gloo gang (``tests/dist_support.py`` ``tp_explain_suite``): the
  leader's ``ModelServer.explain_text`` with each handler gives JAX's
  target and scores within 1e-4 x max|score| + 1e-6, the follower runs
  every explanation as an op of the engine's stream;
- a 2-process ``model_server`` gang with an explainer answers the
  ``:explain`` route with the same scores; SIGTERM ends the leader with
  143 and the follower with 0.
"""

import dataclasses
import json
import signal
import time
import urllib.request

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from dist_support import (  # noqa: E402
    EXPLAIN_METHODS, EXPLAIN_PRESETS, EXPLAIN_PROMPTS, TP_ENGINE_CASES,
    finish, free_port, spawn_gang,
)
from kubeflow_tpu.models import config as jconfig  # noqa: E402
from kubeflow_tpu.models import decoder as jdecoder  # noqa: E402
from kubeflow_tpu.parallel import sharding as jsharding  # noqa: E402
from kubeflow_tpu.runtime.mesh import build_mesh as jax_mesh  # noqa: E402
from kubeflow_tpu.serve import explain as jexplain  # noqa: E402
from kubeflow_tpu_torch.models.convert import params_from_jax  # noqa: E402
from kubeflow_tpu_torch.train.checkpoint import (  # noqa: E402
    CheckpointManager,
)
from port_threads import torch_on_one_thread  # noqa: E402,F401

WORLD = 2


def _jax_cfg(name: str):
    cfg = jconfig.preset(name, dtype="float32")
    return dataclasses.replace(cfg, moe_impl="dense") if cfg.is_moe else cfg


@pytest.fixture(scope="module")
def explained(tmp_path_factory):
    """The gang's records beside JAX's mesh explanations of the same
    prompts and weights."""
    base = tmp_path_factory.mktemp("tp_explain")
    jparams, whole = {}, {}
    for name in EXPLAIN_PRESETS:
        jparams[name] = jdecoder.init_decoder_params(
            jax.random.PRNGKey(0), jconfig.preset(name, dtype="float32"))
        whole[name] = params_from_jax(jax.tree.map(np.asarray,
                                                   jparams[name]),
                                      device="cpu")
    torch.save(whole, base / "params.pt")
    procs = spawn_gang("dist_support:tp_explain_suite",
                       {"out": str(base), "params": str(base / "params.pt")},
                       WORLD, [base / f"w{r}" for r in range(WORLD)],
                       parallelism={"model": WORLD})
    refs = {}
    try:
        mesh = jax_mesh({"model": WORLD}, jax.devices()[:WORLD])
        for name in EXPLAIN_PRESETS:
            cfg = _jax_cfg(name)
            params = jax.device_put(jparams[name], jsharding.shard_params(
                jparams[name], jdecoder.decoder_param_specs(cfg), mesh))
            refs[name] = {m: [getattr(jexplain, m)(p, params=params,
                                                  cfg=cfg, mesh=mesh)
                              for p in EXPLAIN_PROMPTS]
                          for m in EXPLAIN_METHODS}
    finally:
        res = finish(procs)
    for r, (rc, _, err) in enumerate(res):
        assert rc == 0, f"rank {r} exit {rc}:\n{err[-4000:]}"
    recs = [torch.load(base / f"rank{r}.pt", weights_only=False)
            for r in range(WORLD)]
    return {"refs": refs, "ranks": recs, "whole": whole, "base": base}


def _close(got: dict, want: dict) -> None:
    assert got["method"] == want["method"]
    assert got["target_token"] == want["target_token"]
    assert got["target_logprob"] == pytest.approx(want["target_logprob"],
                                                  abs=1e-5)
    w = np.asarray(want["scores"])
    tol = 1e-4 * float(np.max(np.abs(w))) + 1e-6
    np.testing.assert_allclose(got["scores"], w, rtol=0, atol=tol)


@pytest.mark.parametrize("method", EXPLAIN_METHODS)
@pytest.mark.parametrize("name", EXPLAIN_PRESETS)
def test_tp_gang_explains_as_jaxs_mesh_explainer(explained, name, method):
    got = explained["ranks"][0][name][method]
    want = explained["refs"][name][method]
    assert len(got) == len(want) == len(EXPLAIN_PROMPTS)
    for g, w, prompt in zip(got, want, EXPLAIN_PROMPTS):
        _close(g, w)
        assert g["tokens"] == [f" {t}" for t in prompt]


@pytest.mark.parametrize("name", EXPLAIN_PRESETS)
def test_every_explanation_is_an_op_of_the_stream(explained, name):
    """Each explanation went to the follower as one ``_explain`` op, and
    the follower ran every op the leader sent."""
    lead, follow = (r[name]["by_op"] for r in explained["ranks"])
    assert lead == follow
    assert lead["_explain"] == len(EXPLAIN_METHODS) * len(EXPLAIN_PROMPTS)


def _post(url: str, body: dict) -> dict:
    req = urllib.request.Request(url, json.dumps(body).encode(),
                                 {"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return json.loads(resp.read())


def test_model_server_gang_answers_explain(explained, tmp_path):
    """``model_server`` on ``{model: 2}`` with an explainer: the leader's
    ``:explain`` route gives JAX's mesh scores; SIGTERM → 143 and 0."""
    method = "grad_x_input"
    ckpt = tmp_path / "ckpt"
    mgr = CheckpointManager(str(ckpt))
    mgr.save(1, {"params": explained["whole"]["tiny"]})
    mgr.wait()
    port = free_port()
    conf = {"model": {"preset": "tiny", "overrides": {"dtype": "float32"}},
            "storage_uri": f"file://{ckpt}",
            "batching": dict(TP_ENGINE_CASES["contiguous"]), "port": port,
            "service": "tiny", "tokenizer": "dist_support:IdText",
            "explainer": {"handler": method}}
    procs = spawn_gang("model_server", conf, WORLD,
                       [tmp_path / "w0", tmp_path / "w1"],
                       parallelism={"model": WORLD})
    prompt = " ".join(map(str, EXPLAIN_PROMPTS[1]))
    try:
        got, t0 = None, time.monotonic()
        while got is None and time.monotonic() - t0 < 120:
            try:
                got = _post(f"http://127.0.0.1:{port}/v1/models/tiny:explain",
                            {"instances": [prompt]})
            except OSError:
                assert all(p.poll() is None for p in procs)
                time.sleep(0.3)
        procs[0].send_signal(signal.SIGTERM)
    finally:
        res = finish(procs, timeout=60)
    (exp,) = got["explanations"]
    _close(exp, explained["refs"]["tiny"][method][1])
    assert [rc for rc, _, _ in res] == [143, 0], [e[-2000:] for *_, e in res]
