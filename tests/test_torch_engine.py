"""The port's contiguous-cache LLMEngine on the CPU (``device="cpu"``).

Greedy outputs must be token-identical to the port's own full-forward
greedy (re-running the whole sequence each step, no cache) and to the JAX
package's engine on the same weights (``tiny`` at float32, JAX-initialised
params carried across). Sampled modes are checked by distribution:
``jax.random`` and ``torch.Generator`` draw different numbers, so the
frequencies of 20k draws are held to the exact filtered distribution within
0.02 (about six standard deviations)."""

import dataclasses
import time

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from kubeflow_tpu.core.serving import BatchingSpec as JBatchingSpec  # noqa: E402
from kubeflow_tpu.models import config as jconfig  # noqa: E402
from kubeflow_tpu.models import decoder as jdec  # noqa: E402
from kubeflow_tpu.serve import engine as jengine  # noqa: E402
from kubeflow_tpu_torch.core.serving import BatchingSpec  # noqa: E402
from kubeflow_tpu_torch.models import config as tconfig  # noqa: E402
from kubeflow_tpu_torch.models.convert import params_from_jax  # noqa: E402
from kubeflow_tpu_torch.models.decoder import decoder_forward  # noqa: E402
from kubeflow_tpu_torch.serve import engine as E  # noqa: E402
from kubeflow_tpu_torch.serve.device_state import (  # noqa: E402
    DEAD_SLOT, STATE_FIELDS, DecodeState,
)

# Prompts of tests/test_serve_engine.py (its single-request and
# interleaved cases).
SOLO = [5, 17, 3, 99, 42]
INTERLEAVED = [[1, 2, 3], [7] * 20, [9, 8, 7, 6, 5, 4], [30, 31]]


@pytest.fixture(scope="module")
def jcfg():
    return jconfig.preset("tiny", dtype="float32")


@pytest.fixture(scope="module")
def cfg():
    return tconfig.preset("tiny", dtype="float32")


@pytest.fixture(scope="module")
def jparams(jcfg):
    return jdec.init_decoder_params(jax.random.PRNGKey(0), jcfg)


@pytest.fixture(scope="module")
def params(jparams):
    return params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")


def _spec(**kw):
    base = dict(max_batch_size=4, max_seq_len=96, prefill_buckets=[16, 32, 64])
    base.update(kw)
    return BatchingSpec(**base)


@pytest.fixture(scope="module")
def engine(cfg, params):
    return E.LLMEngine(cfg, _spec(), params=params, device="cpu")


def reference_greedy(params, cfg, prompt, n_new):
    """Argmax continuation by full re-forward each step (no cache)."""
    toks = list(prompt)
    for _ in range(n_new):
        logits, _ = decoder_forward(params, torch.tensor([toks]), cfg)
        toks.append(int(torch.argmax(logits[0, -1])))
    return toks[len(prompt):]


def _drive(engine, reqs):
    while not all(r.done.is_set() for r in reqs):
        engine.step()


# -- greedy identity -----------------------------------------------------------

def test_single_request_matches_full_forward(engine, params, cfg):
    got = engine.generate(SOLO, E.SamplingParams(max_new_tokens=12))
    assert got == reference_greedy(params, cfg, SOLO, 12)


def test_interleaved_requests_match_solo(engine, params, cfg):
    want = [reference_greedy(params, cfg, p, 8) for p in INTERLEAVED]
    reqs = [engine.submit(INTERLEAVED[0], E.SamplingParams(max_new_tokens=8)),
            engine.submit(INTERLEAVED[1], E.SamplingParams(max_new_tokens=8))]
    for _ in range(3):
        engine.step()
    reqs += [engine.submit(p, E.SamplingParams(max_new_tokens=8))
             for p in INTERLEAVED[2:]]
    _drive(engine, reqs)
    assert [r.output_tokens for r in reqs] == want


def test_matches_the_jax_engine(jcfg, jparams, params, cfg):
    jeng = jengine.LLMEngine(
        jcfg, JBatchingSpec(max_batch_size=4, max_seq_len=96,
                            prefill_buckets=[16, 32, 64]), params=jparams)
    want = jeng.generate(SOLO, jengine.SamplingParams(max_new_tokens=8))
    eng = E.LLMEngine(cfg, _spec(), params=params, device="cpu")
    assert eng.generate(SOLO, E.SamplingParams(max_new_tokens=8)) == want


@pytest.mark.parametrize("pipelined", [True, False])
def test_chunked_prefill_and_pipelining_keep_greedy_identity(
        pipelined, params, cfg):
    eng = E.LLMEngine(cfg, _spec(chunked_prefill_tokens=16,
                                 pipelined_decode=pipelined, decode_steps=4),
                      params=params, device="cpu")
    long_prompt = [(i * 13) % 250 + 3 for i in range(40)]
    reqs = [eng.submit(long_prompt, E.SamplingParams(max_new_tokens=10)),
            eng.submit(SOLO, E.SamplingParams(max_new_tokens=10))]
    eng.step()
    assert eng._chunkings, "a 40-token prompt must take the 16-token chunks"
    _drive(eng, reqs)
    assert reqs[0].output_tokens == reference_greedy(params, cfg,
                                                     long_prompt, 10)
    assert reqs[1].output_tokens == reference_greedy(params, cfg, SOLO, 10)


@pytest.mark.parametrize("impl", ["gather", "pallas"])
@pytest.mark.parametrize("pipelined", [True, False])
def test_paged_engine_keeps_greedy_identity(pipelined, impl, params, cfg):
    """The paged engine (pages of 16, 16-token chunks, 4-step dispatches
    whose writes cross page boundaries mid-dispatch, requests arriving
    while others decode) against the full-forward reference: exact."""
    eng = E.LLMEngine(cfg, _spec(paged=True, page_size=16,
                                 chunked_prefill_tokens=16, decode_steps=4,
                                 pipelined_decode=pipelined,
                                 paged_attn_impl=impl),
                      params=params, device="cpu")
    long_prompt = [(i * 13) % 250 + 3 for i in range(40)]
    prompts = [long_prompt] + INTERLEAVED
    reqs = [eng.submit(p, E.SamplingParams(max_new_tokens=10))
            for p in prompts[:2]]
    for _ in range(3):
        eng.step()
    reqs += [eng.submit(p, E.SamplingParams(max_new_tokens=10))
             for p in prompts[2:]]
    _drive(eng, reqs)
    for p, r in zip(prompts, reqs):
        assert r.output_tokens == reference_greedy(params, cfg, p, 10)
    eng._allocator.assert_quiescent()


def test_batched_prefill_group_matches_solo(params, cfg):
    eng = E.LLMEngine(cfg, _spec(prefill_batch_max=4), params=params,
                      device="cpu")
    prompts = [[3 + i, 40 + i, 77, 5 * i + 1] for i in range(4)]
    reqs = [eng.submit(p, E.SamplingParams(max_new_tokens=5)) for p in prompts]
    _drive(eng, reqs)
    assert eng.first_token_fetches == 1       # one group, one fetch
    for p, r in zip(prompts, reqs):
        assert r.output_tokens == reference_greedy(params, cfg, p, 5)


def test_dispatch_is_sized_to_the_steps_left(params, cfg):
    """Eager decode runs every step of a dispatch, so the scheduler sizes
    it to the most steps a slot can take: one request of 12 tokens (one
    from prefill) decodes in ONE round, and the pipelined second dispatch
    is skipped because nothing is left after the round in flight."""
    eng = E.LLMEngine(cfg, _spec(), params=params, device="cpu")
    out = eng.generate(SOLO, E.SamplingParams(max_new_tokens=12))
    assert len(out) == 12
    assert eng.decode_rounds == 1


# -- device-side steps -------------------------------------------------------------

def test_dead_rows_never_touch_the_cache(params, cfg):
    """A dead row (free slot, finished slot, or a slot mid chunked prefill
    with real KV at position 0) must leave its cache row bit-identical."""
    b, smax = 2, 16
    shape = (cfg.n_layers, b, smax, cfg.n_kv_heads, cfg.head_dim)
    gen = torch.Generator().manual_seed(0)
    cache = {"k": torch.randn(shape, generator=gen),
             "v": torch.randn(shape, generator=gen)}
    before = {k: v.clone() for k, v in cache.items()}
    live = torch.tensor([True, False])
    out, tokens, lengths, live_out, budgets = E._decode_multi(
        params, cache, torch.tensor([5, 9]), torch.tensor([3, 0]), live,
        torch.zeros(2), torch.zeros(2, dtype=torch.long), torch.ones(2),
        torch.tensor([-1, -1]), torch.tensor([4, 4]), gen, cfg, 3,
        sample_mode="greedy")
    assert torch.equal(cache["k"][:, 1], before["k"][:, 1])
    assert torch.equal(cache["v"][:, 1], before["v"][:, 1])
    assert not torch.equal(cache["k"][:, 0, 3:6], before["k"][:, 0, 3:6])
    assert out[1].tolist() == [-1, -1, -1]
    assert lengths.tolist() == [6, 0] and budgets.tolist() == [1, 4]


def _expected_probs(logits, temp, top_k, top_p):
    scaled = logits / temp
    order = np.argsort(-logits, kind="stable")
    keep = np.zeros_like(logits, dtype=bool)
    srt = scaled[order]
    k = len(logits) if top_k <= 0 else top_k
    srt = np.where(np.arange(len(srt)) < k, srt, -np.inf)
    p = np.exp(srt - srt.max())
    p /= p.sum()
    cum = np.cumsum(p) - p
    kept = (cum < top_p) | (np.arange(len(p)) == 0)
    keep[order[kept & np.isfinite(srt)]] = True
    out = np.where(keep, np.exp(scaled - scaled.max()), 0.0)
    return out / out.sum()


@pytest.mark.parametrize("mode,top_k,top_p", [
    ("plain", 0, 1.0), ("full", 3, 1.0), ("full", 0, 0.8),
    ("full", 4, 0.7)])
def test_sampling_matches_the_filtered_distribution(mode, top_k, top_p):
    rng = np.random.default_rng(0)
    logits = (2 * rng.standard_normal(6)).astype(np.float32)
    n, temp = 20000, 0.7
    want = _expected_probs(logits.astype(np.float64), temp, top_k, top_p)
    rows = np.tile(logits, (n, 1))
    got = E._sample_batch(
        torch.from_numpy(rows), torch.Generator().manual_seed(1),
        torch.full((n,), temp), torch.full((n,), top_k, dtype=torch.long),
        torch.full((n,), top_p), mode=mode)
    freq = np.bincount(got.numpy(), minlength=6) / n
    assert np.max(np.abs(freq - want)) < 0.02
    # The JAX sampler draws from the same filtered distribution.
    jgot = jengine._sample_batch(
        jnp.asarray(rows), jax.random.PRNGKey(1), jnp.full((n,), temp),
        jnp.full((n,), top_k, jnp.int32), jnp.full((n,), top_p), mode=mode)
    jfreq = np.bincount(np.asarray(jgot), minlength=6) / n
    assert np.max(np.abs(jfreq - want)) < 0.02


def test_greedy_rows_ignore_the_sampler():
    rng = np.random.default_rng(2)
    logits = torch.from_numpy(rng.standard_normal((4, 9)).astype(np.float32))
    temps = torch.tensor([0.0, 1.0, 0.0, 1.0])
    for mode in ("greedy", "plain", "full"):
        got = E._sample_batch(logits, torch.Generator().manual_seed(0), temps,
                              torch.zeros(4, dtype=torch.long),
                              torch.ones(4), mode=mode)
        assert got[0] == torch.argmax(logits[0])
        assert got[2] == torch.argmax(logits[2])
    assert E._mode_for([E.SamplingParams()]) == "greedy"
    assert E._mode_for([E.SamplingParams(temperature=1.0)]) == "plain"
    assert E._mode_for([E.SamplingParams(temperature=1.0, top_k=5)]) == "full"


def test_decode_state_syncs_only_dirty_slots():
    ds = DecodeState(3, torch.device("cpu"))
    assert [ds.arrays[n][1].item() for n in STATE_FIELDS] == \
        [pytest.approx(v) for v in DEAD_SLOT]
    ds.mark_slot(1)
    ds.sync_slots(lambda i: (7, 12, True, 0.5, 4, 0.9, 2, 30))
    assert ds.arrays["tokens"].tolist() == [0, 7, 0]
    assert ds.arrays["live"].tolist() == [False, True, False]
    assert ds.arrays["top_p"][1].item() == pytest.approx(0.9)
    assert ds.stats == {"full_state_uploads": 1, "slot_syncs": 1}
    ds.sync_slots(lambda i: pytest.fail("nothing is dirty"))


# -- lifecycle ------------------------------------------------------------------

def test_stop_token_and_metrics(params, cfg):
    eng = E.LLMEngine(cfg, _spec(), params=params, device="cpu")
    first = eng.generate([3, 1, 4], E.SamplingParams(max_new_tokens=6))
    req = eng.submit([3, 1, 4], E.SamplingParams(max_new_tokens=50,
                                                 stop_token=first[2]))
    _drive(eng, [req])
    assert req.finish_reason == "stop"
    assert req.output_tokens == first[:3]
    snap = eng.metrics.snapshot()
    assert snap["requests_completed"] == 2
    assert snap["ttft_p50_ms"] > 0 and req.ttft > 0


def test_deadline_cancel_and_shedding(params, cfg):
    eng = E.LLMEngine(cfg, _spec(max_queue=2, queue_delay_budget=30.0),
                      params=params, device="cpu")
    expired = eng.submit(SOLO, deadline=time.monotonic() - 1.0)
    running = eng.submit([9, 9, 9], E.SamplingParams(max_new_tokens=40))
    with pytest.raises(E.EngineOverloaded):
        eng.submit([1, 2])
    eng.step()
    assert expired.finish_reason == "deadline" and expired.done.is_set()
    assert running.output_tokens and not running.done.is_set()
    running.cancel()
    eng.step()
    assert running.finish_reason == "cancelled"
    assert all(s is None for s in eng.slots)
    snap = eng.metrics.snapshot()
    assert snap["requests_expired"] == 1 and snap["requests_cancelled"] == 1
    assert snap["requests_shed"] == 1


def test_qos_preemption_recomputes_to_the_same_tokens(params, cfg):
    eng = E.LLMEngine(cfg, _spec(max_batch_size=1, decode_steps=2),
                      params=params, device="cpu")
    low = eng.submit(SOLO, E.SamplingParams(max_new_tokens=8), qos="batch")
    eng.step()
    high = eng.submit([30, 31], E.SamplingParams(max_new_tokens=4),
                      qos="interactive")
    _drive(eng, [low, high])
    assert eng.metrics.snapshot()["preemptions"] == 1
    assert high.output_tokens == reference_greedy(params, cfg, [30, 31], 4)
    assert low.output_tokens == reference_greedy(params, cfg, SOLO, 8)


def test_background_loop_streams(params, cfg):
    eng = E.LLMEngine(cfg, _spec(max_batch_size=2), params=params,
                      device="cpu")
    eng.start()
    try:
        req = eng.submit([8, 6, 4], E.SamplingParams(max_new_tokens=5))
        streamed = []
        while (tok := req.stream.get(timeout=30)) is not None:
            streamed.append(tok)
        assert streamed == req.output_tokens and len(streamed) == 5
    finally:
        assert eng.stop()


# -- refusals ---------------------------------------------------------------------

# Paged KV, int8 pages, the engine roles and the host and remote KV tiers
# are served now (tests/test_torch_paged.py, test_torch_handoff.py,
# test_torch_kvtier_host.py, test_torch_kvtier_remote.py); the features
# below are still a later slice — also beside a served one (the remote
# tier with LoRA, and with speculative decoding over int8 pages).
@pytest.mark.parametrize("overrides", [
    {"paged": True, "page_size": 16, "host_kv_pages": 8,
     "remote_kv_root": "kv-remote", "lora": {"max_adapters": 2}},
    {"quantize": "int8"},
    {"paged": True, "page_size": 16, "kv_cache_dtype": "int8",
     "host_kv_pages": 8, "remote_kv_root": "kv-remote",
     "speculative": {"mode": "ngram"}},
    {"role": "decode", "speculative": {"mode": "ngram"}},
    {"lora": {"max_adapters": 2}},
    {"speculative": {"mode": "ngram"}}])
def test_later_slice_features_raise(overrides, cfg, tmp_path):
    if "remote_kv_root" in overrides:
        overrides = dict(overrides, remote_kv_root=str(tmp_path / "kv"))
    with pytest.raises(NotImplementedError):
        E.LLMEngine(cfg, _spec(**overrides), device="cpu")
    assert not (tmp_path / "kv").exists()    # refused before the store


@pytest.mark.parametrize("kv_dtype", [None, "int8"], ids=["float", "int8"])
def test_remote_tier_engine_builds(kv_dtype, cfg, tmp_path):
    """The served combination: the remote tier behind the host tier builds
    its store at the root and starts the migration thread."""
    eng = E.LLMEngine(cfg, _spec(paged=True, page_size=16, host_kv_pages=8,
                                 kv_cache_dtype=kv_dtype,
                                 remote_kv_root=str(tmp_path / "kv")),
                      device="cpu")
    try:
        assert eng._kvtier._remote_store.root == str(tmp_path / "kv")
        assert (tmp_path / "kv").is_dir()
        assert eng._kvtier._thread.is_alive()
        assert eng.kv_pages_remote() == 0
        assert eng.drain_kv_to_remote() == 0      # nothing cached yet
    finally:
        assert eng.stop()


@pytest.mark.parametrize("overrides", [
    {"role": "prefill"}, {"role": "decode"},
    {"role": "prefill", "paged": True, "page_size": 16},
    {"paged": True, "page_size": 16, "host_kv_pages": 8}])
def test_roles_and_the_host_tier_construct(overrides, cfg):
    eng = E.LLMEngine(cfg, _spec(**overrides), device="cpu")
    try:
        assert eng.role == overrides.get("role", "unified")
        assert eng.kv_pages_host() == 0
    finally:
        eng.stop()


def test_int8_kv_needs_the_page_pool(cfg):
    """As in the JAX engine: int8 KV exists only in paged mode, and no
    other KV dtype is known."""
    with pytest.raises(ValueError, match="paged=True"):
        E.LLMEngine(cfg, _spec(kv_cache_dtype="int8"), device="cpu")
    with pytest.raises(ValueError, match="kv_cache_dtype"):
        E.LLMEngine(cfg, _spec(paged=True, page_size=16,
                               kv_cache_dtype="fp8"), device="cpu")
    with pytest.raises(ValueError):
        jengine.LLMEngine(jconfig.preset("tiny", dtype="float32"),
                          JBatchingSpec(max_batch_size=4, max_seq_len=96,
                                        kv_cache_dtype="int8"))


def test_moe_and_mesh_raise(cfg):
    with pytest.raises(NotImplementedError):
        E.LLMEngine(tconfig.preset("tiny-moe"), _spec(), device="cpu")
    with pytest.raises(NotImplementedError):
        E.LLMEngine(cfg, _spec(), device="cpu", mesh=object())


def test_default_device_is_cuda_and_never_falls_back(cfg):
    """Without a card, an engine built without ``device=`` raises instead
    of moving to the CPU quietly."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        E.LLMEngine(cfg, _spec())


def test_submit_validates_its_input(engine):
    with pytest.raises(ValueError):
        engine.submit([])
    with pytest.raises(ValueError):
        engine.submit([1] * 96)
    with pytest.raises(ValueError):
        engine.submit([1, 256])            # outside the 256-token vocab
    with pytest.raises(ValueError):
        engine.submit([1, 2], qos="platinum")


def test_bucket_and_prefill_impl_rules(cfg, params):
    eng = E.LLMEngine(cfg, _spec(), params=params, device="cpu")
    assert [eng._bucket_for(n) for n in (1, 16, 17, 64, 80)] == \
        [16, 16, 32, 64, 96]
    # "auto" reads "on CUDA" where the JAX engine reads "on TPU".
    assert eng.prefill_impl(2048) == "xla"
    forced = E.LLMEngine(cfg, _spec(prefill_attn_impl="pallas"),
                         params=params, device="cpu")
    assert forced.prefill_impl(16) == "pallas"
    assert dataclasses.asdict(BatchingSpec())["prefill_buckets"] == \
        JBatchingSpec().prefill_buckets
