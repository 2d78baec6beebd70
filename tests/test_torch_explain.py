"""The port's explainer hop (``serve/explain.py``) on the CPU against the
JAX package's explainers on the same weights (``params_from_jax``): the
same target token and scores within 1e-4 x max|score| + 1e-6 (fp32, tiny
preset), with the fused-kernel path's plain versions as well as the plain
ops; the finite-difference check of ``tests/test_serve_explain.py``; and
the ``:explain`` route's answers, including its two 400s."""

import json
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from kubeflow_tpu.models import config as jconfig  # noqa: E402
from kubeflow_tpu.models import decoder as jdecoder  # noqa: E402
from kubeflow_tpu.serve import explain as jexplain  # noqa: E402
from kubeflow_tpu_torch.core.serving import BatchingSpec  # noqa: E402
from kubeflow_tpu_torch.models.config import preset  # noqa: E402
from kubeflow_tpu_torch.models.convert import params_from_jax  # noqa: E402
from kubeflow_tpu_torch.models.decoder import decoder_forward  # noqa: E402
from kubeflow_tpu_torch.serve.engine import LLMEngine  # noqa: E402
from kubeflow_tpu_torch.serve.explain import (  # noqa: E402
    build_explainer, grad_x_input, leave_one_out,
)
from kubeflow_tpu_torch.serve.server import ModelServer  # noqa: E402
from port_threads import torch_on_one_thread  # noqa: E402,F401

TOKENS = [5, 17, 3, 99, 42, 7]
EXPLAINERS = {"grad_x_input": grad_x_input, "leave_one_out": leave_one_out}
PRESETS = ("tiny", "tiny-gemma")


@pytest.fixture(scope="module", params=PRESETS)
def pair(request):
    jcfg = jconfig.preset(request.param, dtype="float32")
    jparams = jdecoder.init_decoder_params(jax.random.PRNGKey(0), jcfg)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, jparams, preset(request.param, dtype="float32"), params


def _close(got: dict, want: dict) -> None:
    assert got["method"] == want["method"]
    assert got["target_token"] == want["target_token"]
    assert got["target_logprob"] == pytest.approx(want["target_logprob"],
                                                  abs=1e-5)
    w = np.asarray(want["scores"])
    tol = 1e-4 * float(np.max(np.abs(w))) + 1e-6
    np.testing.assert_allclose(got["scores"], w, rtol=0, atol=tol)


@pytest.mark.parametrize("fused", ["off", "on"])
@pytest.mark.parametrize("method", ["grad_x_input", "leave_one_out"])
def test_matches_the_jax_explainer(pair, method, fused):
    import dataclasses

    jcfg, jparams, cfg, params = pair
    cfg = dataclasses.replace(cfg, fused_kernels=fused)
    got = EXPLAINERS[method](TOKENS, params=params, cfg=cfg)
    want = getattr(jexplain, method)(TOKENS, params=jparams, cfg=jcfg)
    _close(got, want)


def test_grad_x_input_matches_finite_difference(pair):
    """score_i is the directional derivative of the target log-prob along
    e_i: shrinking token i's embedding by epsilon changes the log-prob by
    ~ -epsilon x score_i."""
    _, _, cfg, params = pair
    out = grad_x_input(TOKENS, params=params, cfg=cfg)
    target = out["target_token"]
    toks = torch.tensor([TOKENS])
    embeds = params["embed"][toks].float()

    def lp_of(e):
        with torch.no_grad():
            logits, _ = decoder_forward(params, toks, cfg, inputs_embeds=e)
        return float(torch.log_softmax(logits[0, -1], -1)[target])

    eps = 1e-3
    for i in (0, 3, len(TOKENS) - 1):
        perturbed = embeds.clone()
        perturbed[0, i] *= 1.0 - eps
        fd = (lp_of(embeds) - lp_of(perturbed)) / eps
        assert fd == pytest.approx(out["scores"][i], rel=0.05, abs=1e-3)


def test_inputs_embeds_reproduce_the_token_forward(pair):
    _, _, cfg, params = pair
    toks = torch.tensor([TOKENS])
    with torch.no_grad():
        a, _ = decoder_forward(params, toks, cfg)
        b, _ = decoder_forward(params, toks, cfg,
                               inputs_embeds=params["embed"][toks])
    assert torch.equal(a, b)


def test_leave_one_out_is_the_per_ablation_forward(pair):
    _, _, cfg, params = pair
    out = leave_one_out(TOKENS, params=params, cfg=cfg, ablate_token=9)
    for i in (1, 4):
        ablated = list(TOKENS)
        ablated[i] = 9
        with torch.no_grad():
            logits, _ = decoder_forward(params, torch.tensor([ablated]), cfg)
        lp = float(torch.log_softmax(logits[0, -1], -1)[out["target_token"]])
        assert out["scores"][i] == pytest.approx(
            out["target_logprob"] - lp, abs=1e-4)


def test_handlers_resolve():
    assert build_explainer(None) is None
    assert build_explainer({"handler": "grad_x_input"}) is grad_x_input
    with pytest.raises(KeyError, match="not registered"):
        build_explainer({"handler": "nope"})
    part = build_explainer({"handler": "leave_one_out",
                            "config": {"ablate_token": 3}})
    assert part.func is leave_one_out and part.keywords == {"ablate_token": 3}


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def _server(explainer, max_seq_len=64):
    cfg = preset("tiny", vocab_size=512, dtype="float32")
    engine = LLMEngine(cfg, BatchingSpec(max_batch_size=2,
                                         max_seq_len=max_seq_len,
                                         prefill_buckets=[16]),
                       device="cpu")
    server = ModelServer("exp", engine, explainer=explainer)
    server.start()
    return server


def test_explain_route_serves_scores():
    server = _server(build_explainer({"handler": "grad_x_input"}))
    try:
        out = _post(server.url + "/v1/models/exp:explain",
                    {"instances": ["hi"]})
        (exp,) = out["explanations"]
        assert exp["method"] == "grad_x_input"
        assert len(exp["scores"]) == len(exp["tokens"]) >= 2
        assert all(np.isfinite(s) for s in exp["scores"])
        assert isinstance(exp["predicted_text"], str)
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(server.url + "/v1/models/other:explain",
                  {"instances": ["hi"]})
        assert ei.value.code == 404
    finally:
        server.stop()


def test_overlong_explain_prompt_is_400():
    server = _server(build_explainer({"handler": "leave_one_out"}),
                     max_seq_len=32)
    try:
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(server.url + "/v1/models/exp:explain",
                  {"instances": ["x" * 200]})
        assert ei.value.code == 400
        assert "limit" in json.loads(ei.value.read())["error"]
    finally:
        server.stop()


def test_explain_without_explainer_is_400():
    server = _server(None)
    try:
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(server.url + "/v1/models/exp:explain",
                  {"instances": ["hi"]})
        assert ei.value.code == 400
    finally:
        server.stop()


def _moe_prompts() -> list[str]:
    """Four 23-character prompts (24 byte tokens with the BOS) drawn from
    a seeded generator: at 24 tokens tiny-moe's dispatch capacity (16
    slots an expert at factor 1.25) binds."""
    rng = np.random.default_rng(0)
    return ["".join(chr(c) for c in rng.integers(48, 123, 23))
            for _ in range(4)]


@pytest.fixture(scope="module")
def moe_server():
    """A ``ModelServer`` over a tiny-moe engine on its default dispatch
    path, on JAX-initialised weights; JAX's config and weights beside it."""
    jcfg = jconfig.preset("tiny-moe", dtype="float32")
    jparams = jdecoder.init_decoder_params(jax.random.PRNGKey(0), jcfg)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    cfg = preset("tiny-moe", dtype="float32")
    assert cfg.moe_impl == "dispatch"
    engine = LLMEngine(cfg, BatchingSpec(max_batch_size=2, max_seq_len=64,
                                         prefill_buckets=[32]),
                       params=params, device="cpu")
    yield jcfg, jparams, cfg, params, engine


@pytest.mark.parametrize("method", ["grad_x_input", "leave_one_out"])
def test_moe_explain_runs_the_dense_path_as_jaxs_server(moe_server, method):
    """JAX's ``ModelServer.explain_text`` swaps an MoE model to
    ``moe_impl="dense"`` before attribution; the port's ``explain_text``
    on a dispatch engine gives JAX's scores on that path, while the
    dispatch path's own scores differ where capacity binds."""
    import dataclasses

    jcfg, jparams, cfg, params, engine = moe_server
    server = ModelServer("moe", engine,
                         explainer=build_explainer({"handler": method}))
    jdense = dataclasses.replace(jcfg, moe_impl="dense")
    apart = 0.0
    for prompt in _moe_prompts():
        toks = server.tokenizer.encode(prompt)
        assert len(toks) == 24
        got = server.explain_text(prompt, None)
        want = getattr(jexplain, method)(toks, params=jparams, cfg=jdense)
        _close(got, want)
        dispatch = EXPLAINERS[method](toks, params=params, cfg=cfg)
        apart = max(apart, float(np.max(np.abs(
            np.asarray(dispatch["scores"]) - np.asarray(want["scores"])))))
    assert apart > 1e-3
