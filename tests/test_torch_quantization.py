"""int8 weight-only serving in the port (``ops/quantization.py``, the
quantized draw and load, the engine's ``quantize="int8"``) on the CPU, held
against the JAX package's ``kubeflow_tpu/ops/quantization.py`` on the same
numpy-seeded inputs and on weights carried across by
``convert.params_from_jax``, fp32:

- ``quantize_weight``: q bit-equal to JAX's, scale within 1e-7 relative
  (random, all-zero and extreme channels, each contraction layout);
- ``quantize_params_int8``: which leaves pack and their layouts, for
  ``tiny`` and ``tiny-moe``; JAX ``QuantizedTensor`` leaves come across
  bit for bit;
- the per-layer quantized draw (``init_decoder_params(...,
  quantize="int8")``) and ``load_params(..., quantize="int8")`` from
  ``random://`` and ``file://`` equal draw-then-quantize bit for bit;
- ``packed_param_bytes`` and ``packed_param_bytes_estimate`` equal JAX's
  for ``tiny``, ``tiny-moe``, ``llama3-8b`` and ``mixtral-8x7b``;
- the forward over the same ``QuantizedTensor``s equals JAX's to 1e-5
  (``tiny``, ``tiny-moe``); int8 engines give the JAX int8 engine's greedy
  tokens (contiguous, paged); ``quantization_quality`` equals JAX's;
- ``estimate_model_bytes`` with ``quantize`` equals JAX's, and a
  repository server holds an int8 Mixtral entry beside a served int8
  model."""

import json
import urllib.request

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from kubeflow_tpu.core.serving import BatchingSpec as JBatchingSpec  # noqa: E402
from kubeflow_tpu.models import config as jconfig  # noqa: E402
from kubeflow_tpu.models import decoder as jdecoder  # noqa: E402
from kubeflow_tpu.ops import quantization as jquant  # noqa: E402
from kubeflow_tpu.serve import engine as jengine  # noqa: E402
from kubeflow_tpu.serve import repository as jrepo  # noqa: E402
from kubeflow_tpu_torch.core.serving import BatchingSpec  # noqa: E402
from kubeflow_tpu_torch.models import config as tconfig  # noqa: E402
from kubeflow_tpu_torch.models import decoder as tdecoder  # noqa: E402
from kubeflow_tpu_torch.models.convert import params_from_jax  # noqa: E402
from kubeflow_tpu_torch.ops import quantization as tquant  # noqa: E402
from kubeflow_tpu_torch.ops.quantization import QuantizedTensor  # noqa: E402
from kubeflow_tpu_torch.serve.engine import LLMEngine, SamplingParams  # noqa: E402
from kubeflow_tpu_torch.serve.repository import (  # noqa: E402
    ModelRepository, estimate_model_bytes,
)
from kubeflow_tpu_torch.serve.server import ModelServer  # noqa: E402
from kubeflow_tpu_torch.serve.storage import load_params  # noqa: E402
from kubeflow_tpu_torch.train.checkpoint import CheckpointManager  # noqa: E402
from port_threads import torch_on_one_thread  # noqa: E402,F401

TOL = 1e-5
PROMPTS = [[5, 17, 3, 99, 42], list(range(1, 40)), [7] * 20, [9, 8, 7, 6]]


def _cfgs(name, **over):
    over.setdefault("dtype", "float32")
    return jconfig.preset(name, **over), tconfig.preset(name, **over)


def _jax_params(jc, seed=0):
    jp = jdecoder.init_decoder_params(jax.random.PRNGKey(seed), jc)
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


def _np(t):
    return np.asarray(t.detach() if isinstance(t, torch.Tensor) else t)


def _same(got, want) -> bool:
    if isinstance(want, torch.Tensor):
        return got.dtype == want.dtype and torch.equal(got, want)
    return np.array_equal(_np(got), _np(want))


def assert_same_leaf(got, want):
    """A port leaf equal bit for bit to another (port or JAX)."""
    if hasattr(want, "q"):
        assert isinstance(got, QuantizedTensor)
        assert _same(got.q, want.q) and _same(got.scale, want.scale)
    else:
        assert _same(got, want)


def assert_same_tree(got, want):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            assert_same_tree(got[k], want[k])
    else:
        assert_same_leaf(got, want)


def close(got, want, tol=TOL):
    got, want = _np(got), _np(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= tol * scale


# -- the scheme ---------------------------------------------------------------------

def _weights():
    rng = np.random.default_rng(0)
    extreme = (rng.standard_normal((32, 6)) * 1e-3).astype(np.float32)
    extreme[:, 0] = 3e4
    extreme[:, 1] = 1e-12
    extreme[3, 2] = -7e3
    half = np.tile(np.array([127.0, 0.5, 1.5, -2.5], np.float32)[:, None],
                   (1, 5))
    return {
        "random": (rng.standard_normal((48, 24)).astype(np.float32), (0,)),
        "zeros": (np.zeros((16, 8), np.float32), (0,)),
        "extreme": (extreme, (0,)),
        "ties-half": (half, (0,)),
        "wo-layout": (rng.standard_normal((4, 8, 12)).astype(np.float32),
                      (0, 1)),
        "expert-layout": (rng.standard_normal((3, 10, 7)).astype(np.float32),
                          (1,)),
        "stacked": (rng.standard_normal((2, 3, 10, 7)).astype(np.float32),
                    (2,)),
    }


@pytest.mark.parametrize("case", list(_weights()))
def test_quantize_weight_equals_jax(case):
    w, dims = _weights()[case]
    jq = jquant.quantize_weight(jnp.asarray(w), dims)
    tq = tquant.quantize_weight(torch.from_numpy(w), dims)
    assert tq.q.dtype == torch.int8 and tuple(tq.q.shape) == w.shape
    assert np.array_equal(tq.q.numpy(), np.asarray(jq.q))
    js = np.asarray(jq.scale)
    assert tq.scale.shape == js.shape
    assert np.all(np.abs(tq.scale.numpy() - js) <= 1e-7 * np.abs(js))
    for dt in (torch.float32, torch.bfloat16):
        jdt = jnp.float32 if dt == torch.float32 else jnp.bfloat16
        want = np.asarray(jq.astype(jdt).astype(jnp.float32))
        assert np.array_equal(tq.dequant(dt).float().numpy(), want)
    if case == "zeros":
        assert not tq.q.any()


@pytest.mark.parametrize("name", ["tiny", "tiny-moe"])
def test_quantize_params_layout_and_jax_leaves(name):
    jc, tc = _cfgs(name)
    jp, tp = _jax_params(jc)
    jq = jquant.quantize_params_int8(jp, jc)
    tq = tquant.quantize_params_int8(tp, tc)
    lay = tq["layers"]
    for n in ("wq", "wk", "wv", "wo"):
        assert isinstance(lay["attn"][n], QuantizedTensor), n
    for n in ("gate", "up", "down"):
        assert isinstance(lay["mlp"][n], QuantizedTensor), n
    for leaf in (tq["embed"], lay["ln1"], lay["ln2"], tq["final_norm"]):
        assert isinstance(leaf, torch.Tensor)
    if tc.is_moe:
        assert isinstance(lay["mlp"]["router"], torch.Tensor)
        assert lay["mlp"]["gate"].scale.shape == (
            tc.n_layers, tc.num_experts, 1, tc.mlp_dim)
        assert lay["mlp"]["down"].scale.shape == (
            tc.n_layers, tc.num_experts, 1, tc.hidden)
    assert lay["attn"]["wq"].scale.shape == (tc.n_layers, 1, tc.n_heads,
                                             tc.head_dim)
    assert lay["attn"]["wo"].scale.shape == (tc.n_layers, 1, 1, tc.hidden)
    assert isinstance(tq["lm_head"], QuantizedTensor)
    # The JAX tree's QuantizedTensors carried across are the same bits.
    assert_same_tree(params_from_jax(jax.tree.map(np.asarray, jq),
                                     device="cpu"), tq)
    # Quantizing again leaves packed leaves as they are.
    again = tquant.quantize_params_int8(tq, tc)
    assert again["layers"]["attn"]["wq"] is lay["attn"]["wq"]
    # A layer view slices both fields.
    view = tdecoder.layer_view(lay, 1)["attn"]["wq"]
    assert torch.equal(view.q, lay["attn"]["wq"].q[1])
    assert torch.equal(view.scale, lay["attn"]["wq"].scale[1])


@pytest.mark.parametrize("name", ["tiny", "tiny-moe", "tiny-gemma"])
def test_per_layer_quantized_draw_equals_draw_then_quantize(name):
    _, tc = _cfgs(name)
    for dt in (None, torch.bfloat16):
        packed = tdecoder.init_decoder_params(
            torch.Generator().manual_seed(3), tc, dtype=dt, quantize="int8")
        full = tdecoder.init_decoder_params(
            torch.Generator().manual_seed(3), tc, dtype=dt)
        assert_same_tree(packed, tquant.quantize_params_int8(full, tc))


def test_quantized_loads_equal_draw_then_quantize(tmp_path):
    _, tc = _cfgs("tiny-moe")
    full = load_params("random://", tc, seed=4, device="cpu")
    want = tquant.quantize_params_int8(full, tc)
    assert_same_tree(load_params("random://", tc, seed=4, device="cpu",
                                 quantize="int8"), want)
    ckpt = tmp_path / "ckpt"
    mgr = CheckpointManager(str(ckpt))
    assert mgr.save(2, {"params": full, "step": 2})
    mgr.close()       # the save is asynchronous
    got = load_params(f"file://{ckpt}", tc, device="cpu", quantize="int8")
    assert_same_tree(got, want)
    with pytest.raises(ValueError, match="quantize"):
        load_params("random://", tc, device="cpu", quantize="fp4")


# -- byte counts --------------------------------------------------------------------

@pytest.mark.parametrize("name", ["tiny", "tiny-moe", "tiny-gemma"])
def test_packed_bytes_of_trees_equal_jax(name):
    jc, tc = _cfgs(name)
    jp, tp = _jax_params(jc)
    jq = jquant.quantize_params_int8(jp, jc)
    tq = tquant.quantize_params_int8(tp, tc)
    want = jquant.packed_param_bytes(jq)
    assert tquant.packed_param_bytes(tq) == want
    assert tquant.packed_param_bytes_estimate(tc) == want
    assert jquant.packed_param_bytes_estimate(jc) == want
    assert tquant.packed_param_bytes(tp) == jquant.packed_param_bytes(jp)


@pytest.mark.parametrize("name,param_dtype", [
    ("llama3-8b", "bfloat16"), ("mixtral-8x7b", "bfloat16"),
    ("llama3-8b", "float32"), ("mixtral-8x7b", "float32")])
def test_packed_bytes_estimate_equals_jax(name, param_dtype):
    jc, tc = _cfgs(name, param_dtype=param_dtype)
    want = jquant.packed_param_bytes_estimate(jc)
    assert tquant.packed_param_bytes_estimate(tc) == want
    if param_dtype == "bfloat16":
        gb = want / 1e9
        assert (8.5 < gb < 8.6) if name == "llama3-8b" else (46.8 < gb < 46.9)
        assert tc.num_params() * 2 > 1.8 * want


# -- forward and engines ------------------------------------------------------------

@pytest.mark.parametrize("name", ["tiny", "tiny-moe"])
def test_int8_forward_equals_jax(name):
    jc, tc = _cfgs(name)
    jp, tp = _jax_params(jc, seed=1)
    jq = jquant.quantize_params_int8(jp, jc)
    tq = tquant.quantize_params_int8(tp, tc)
    toks = np.random.default_rng(2).integers(0, jc.vocab_size, (2, 20))
    want, _, _ = jdecoder.decoder_forward(jq, jnp.asarray(toks), jc)
    got, _ = tdecoder.decoder_forward(tq, torch.from_numpy(toks), tc)
    close(got, want)
    full, _ = tdecoder.decoder_forward(tp, torch.from_numpy(toks), tc)
    assert float((got - full).abs().max()) > 0     # the weights did change


def _batching(**kw):
    base = dict(max_batch_size=4, max_seq_len=96, prefill_buckets=[16, 64],
                chunked_prefill_tokens=32, page_size=16, decode_steps=4,
                quantize="int8")
    base.update(kw)
    return base


def _gen(eng, sp_cls, **sp):
    reqs = [eng.submit(list(p), sp_cls(max_new_tokens=10, **sp))
            for p in PROMPTS]
    for _ in range(3000):
        if all(r.done.is_set() for r in reqs):
            break
        eng.step()
    return [list(r.output_tokens) for r in reqs]


@pytest.fixture(scope="module")
def tiny():
    jc, tc = _cfgs("tiny", vocab_size=512)
    return (jc, tc) + _jax_params(jc, seed=2)


@pytest.mark.parametrize("layout", ["contiguous", "paged", "paged-int8-kv"])
def test_int8_engine_tokens_equal_jax(tiny, layout):
    jc, tc, jp, tp = tiny
    kw = {"contiguous": {}, "paged": {"paged": True},
          "paged-int8-kv": {"paged": True, "kv_cache_dtype": "int8"}}[layout]
    jkw = dict(kw, paged_attn_impl="gather") if kw else {}
    jeng = jengine.LLMEngine(jc, JBatchingSpec(**_batching(**jkw)),
                             params=jp)
    want = _gen(jeng, jengine.SamplingParams, temperature=0.0)
    eng = LLMEngine(tc, BatchingSpec(**_batching(**kw)), params=tp,
                    device="cpu")
    assert isinstance(eng.params["layers"]["attn"]["wq"], QuantizedTensor)
    assert _gen(eng, SamplingParams) == want
    # An already-packed tree (a quantized load) serves the same tokens.
    packed = tquant.quantize_params_int8(tp, tc)
    eng2 = LLMEngine(tc, BatchingSpec(**_batching(**kw)), params=packed,
                     device="cpu")
    assert eng2.params["lm_head"].q is packed["lm_head"].q
    assert _gen(eng2, SamplingParams) == want


def test_int8_moe_engine_tokens_equal_jax():
    jc, tc = _cfgs("tiny-moe")
    jp, tp = _jax_params(jc)
    kw = dict(paged=True)
    jeng = jengine.LLMEngine(
        jc, JBatchingSpec(**_batching(paged_attn_impl="gather", **kw)),
        params=jp)
    want = _gen(jeng, jengine.SamplingParams, temperature=0.0)
    eng = LLMEngine(tc, BatchingSpec(**_batching(**kw)), params=tp,
                    device="cpu")
    assert _gen(eng, SamplingParams) == want


def test_bad_quantize_is_refused_as_by_jax(tiny):
    jc, tc, jp, tp = tiny
    with pytest.raises(ValueError, match="quantize") as jexc:
        jengine.LLMEngine(jc, JBatchingSpec(**_batching(quantize="fp4")),
                          params=jp)
    with pytest.raises(ValueError, match="quantize") as texc:
        LLMEngine(tc, BatchingSpec(**_batching(quantize="fp4")), params=tp,
                  device="cpu")
    assert str(texc.value) == str(jexc.value)


@pytest.mark.parametrize("name", ["tiny", "tiny-moe"])
def test_quantization_quality_equals_jax(name):
    jc, tc = _cfgs(name)
    jp, tp = _jax_params(jc, seed=5)
    prompts = [[1, 5, 9, 2], [3, 3, 7]]
    want = jquant.quantization_quality(
        jc, jp, jquant.quantize_params_int8(jp, jc), prompts, max_new=3)
    got = tquant.quantization_quality(
        tc, tp, tquant.quantize_params_int8(tp, tc), prompts, max_new=3)
    assert got["tokens_compared"] == want["tokens_compared"] == 6
    assert got["greedy_match_rate"] == want["greedy_match_rate"]
    assert abs(got["mean_abs_logprob_delta"]
               - want["mean_abs_logprob_delta"]) <= TOL


# -- the repository -----------------------------------------------------------------

@pytest.mark.parametrize("name", ["tiny", "tiny-moe", "llama3-8b",
                                  "mixtral-8x7b"])
@pytest.mark.parametrize("kv", [None, "int8"], ids=["kv-full", "kv-int8"])
def test_estimate_model_bytes_int8_equals_jax(name, kv):
    over = {} if name.startswith("tiny") else {"param_dtype": "bfloat16"}
    jc, tc = _cfgs(name, **over)
    spec = dict(max_batch_size=8, max_seq_len=128 if name.startswith("tiny")
                else 2048, quantize="int8")
    if kv:
        spec.update(paged=True, kv_cache_dtype=kv)
    want = jrepo.estimate_model_bytes(jc, JBatchingSpec(**spec))
    assert estimate_model_bytes(tc, BatchingSpec(**spec)) == want
    assert want < estimate_model_bytes(
        tc, BatchingSpec(**dict(spec, quantize=None)))


def test_repository_holds_an_int8_mixtral_entry():
    """An 80 GB budget: Mixtral-8x7B in bf16 is priced over it, in int8
    under it (at JAX's number); the repository server serves an int8
    ``tiny-moe`` built from a seed beside the registered Mixtral entry."""
    spec = dict(max_batch_size=8, max_seq_len=2048, paged=True,
                quantize="int8")
    jmix, tmix = _cfgs("mixtral-8x7b", param_dtype="bfloat16")
    repo = ModelRepository(max_loaded=1, max_bytes=80 * 10 ** 9,
                           device="cpu")
    entry = repo.register("mixtral", tmix, batching=BatchingSpec(**spec))
    assert entry.bytes == jrepo.estimate_model_bytes(
        jmix, JBatchingSpec(**spec))
    assert entry.bytes < 80 * 10 ** 9 < estimate_model_bytes(
        tmix, BatchingSpec(**dict(spec, quantize=None)))
    _, tc = _cfgs("tiny-moe")
    small = dict(max_batch_size=2, max_seq_len=64, prefill_buckets=[16],
                 quantize="int8")
    repo.register("moe-int8", tc, batching=BatchingSpec(**small))
    ref = LLMEngine(tc, BatchingSpec(**small), seed=0, device="cpu")
    tok = repo.peek("moe-int8").tokenizer
    want = ref.generate(tok.encode("hi"), SamplingParams(max_new_tokens=6))
    srv = ModelServer("moe-int8", repository=repo)
    srv.start()
    try:
        body = json.dumps({"model": "moe-int8", "prompt": "hi",
                           "max_tokens": 6}).encode()
        req = urllib.request.Request(
            srv.url + "/v1/completions", data=body,
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            out = json.loads(r.read())
        got = repo.peek("moe-int8").engine
        assert isinstance(got.params["layers"]["mlp"]["gate"],
                          QuantizedTensor)
        assert out["choices"][0]["text"] == tok.decode(want)
        with urllib.request.urlopen(srv.url + "/v2/repository/index",
                                    timeout=30) as r:
            states = {m["name"]: m["state"]
                      for m in json.loads(r.read())["models"]}
        assert states["mixtral"] != "READY" and states["moe-int8"] == "READY"
    finally:
        srv.stop()
        repo.shutdown()
