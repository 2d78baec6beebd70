"""Speculative decoding in the port (``serve/spec_decode.py``, the engine's
spec path, the worker) on the CPU, held against the JAX package on the same
numpy-seeded inputs and on weights carried across by
``convert.params_from_jax``, fp32, ``tiny`` with a 512 vocabulary (and
``tiny-gemma`` for softcap, tied embeddings and the embedding scale):

- ``ngram_propose`` equals the JAX function on its four cases and on
  random contexts;
- ``verify_step`` / ``paged_verify_step`` (float and int8 pools) give the
  JAX functions' greedy ids, write the same cache or pool within 1e-5, and
  leave it unchanged for dead rows and positions past its end;
  ``draft_propose`` gives the JAX ids; the virtual-row kernel wrapper's
  plain path equals the gather path;
- through the engine, every (drafter × KV layout) gives the port's plain
  engine's and the JAX plain engine's greedy tokens exactly, on prompts
  that are sure to draft (P + G + P, G being P's greedy continuation, or a
  self-draft), with ``spec_rounds`` and ``spec_drafted`` above zero;
  sampled traffic takes the plain path; a stop token and a budget inside a
  round; a rejection-heavy draft leaks no page; rollback truncates the
  table; prefix pages survive rollback; a decode-role engine runs spec
  rounds on an adopted request;
- ``BatchingSpec(speculative=...)`` accepts "off" and a JAX dump, refuses
  bad modes and LoRA beside spec with the JAX messages; a worker serves
  with ``batching.speculative`` and shows the spec gauges on /metrics."""

import json
import os
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from kubeflow_tpu.core.serving import BatchingSpec as JBatchingSpec  # noqa: E402
from kubeflow_tpu.core.serving import SpeculativeSpec as JSpeculativeSpec  # noqa: E402
from kubeflow_tpu.models import config as jconfig  # noqa: E402
from kubeflow_tpu.models.decoder import init_decoder_params  # noqa: E402
from kubeflow_tpu.serve import engine as jengine  # noqa: E402
from kubeflow_tpu.serve import spec_decode as jspec  # noqa: E402
from kubeflow_tpu_torch.core.serving import (  # noqa: E402
    BatchingSpec, SpeculativeSpec,
)
from kubeflow_tpu_torch.models import config as tconfig  # noqa: E402
from kubeflow_tpu_torch.models.convert import params_from_jax  # noqa: E402
from kubeflow_tpu_torch.ops.paged_attention import (  # noqa: E402
    paged_verify_attention,
)
from kubeflow_tpu_torch.ops.quantization import dequantize_kv  # noqa: E402
from kubeflow_tpu_torch.runtime.bootstrap import WorkerEnv, free_port  # noqa: E402
from kubeflow_tpu_torch.serve import spec_decode as tspec  # noqa: E402
from kubeflow_tpu_torch.serve.engine import LLMEngine, SamplingParams  # noqa: E402
from kubeflow_tpu_torch.serve.handoff import HandoffPayload  # noqa: E402
from kubeflow_tpu_torch.serve.paged import paged_gather  # noqa: E402
from kubeflow_tpu_torch.serve.tokenizer import ByteTokenizer  # noqa: E402
from port_threads import torch_on_one_thread  # noqa: E402,F401

REPO = Path(__file__).resolve().parent.parent
TOL = 1e-5
PROMPTS = [[5, 17, 3, 99, 42], list(range(1, 50)), [7] * 20,
           [9, 8, 7, 6, 5, 4]]
NGRAM = {"mode": "ngram", "k": 4}
#: A 1-layer random draft: it rejects almost every round.
BAD_DRAFT = {"mode": "draft_model", "k": 4,
             "draft": {"preset": "tiny", "overrides": {
                 "vocab_size": 512, "dtype": "float32", "n_layers": 1}}}
#: The target itself as the draft (``draft_params`` = its weights).
SELF_DRAFT = {"mode": "draft_model", "k": 4,
              "draft": {"preset": "tiny", "overrides": {
                  "vocab_size": 512, "dtype": "float32"}}}
LAYOUTS = {"dense": {}, "paged": {"paged": True},
           "int8": {"paged": True, "kv_cache_dtype": "int8"}}


@pytest.fixture(scope="module")
def jcfg():
    return jconfig.preset("tiny", vocab_size=512, dtype="float32")


@pytest.fixture(scope="module")
def cfg():
    return tconfig.preset("tiny", vocab_size=512, dtype="float32")


@pytest.fixture(scope="module")
def jparams(jcfg):
    return init_decoder_params(jax.random.PRNGKey(0), jcfg)


@pytest.fixture(scope="module")
def params(jparams):
    return params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")


def _batching(**kw):
    base = dict(max_batch_size=4, max_seq_len=128, prefill_buckets=[16, 64],
                chunked_prefill_tokens=32, page_size=16, decode_steps=4)
    base.update(kw)
    return base


def port_engine(cfg, params, spec=None, draft_params=None, **kw):
    if spec is not None:
        kw["speculative"] = spec
    return LLMEngine(cfg, BatchingSpec(**_batching(**kw)), params=params,
                     device="cpu", draft_params=draft_params)


def gen_all(eng, prompts, n=12, **sp):
    params = SamplingParams(max_new_tokens=n, **sp)
    reqs = [eng.submit(list(p), params) for p in prompts]
    for _ in range(3000):
        if all(r.done.is_set() for r in reqs):
            break
        eng.step()
    assert all(r.done.is_set() for r in reqs), "requests did not finish"
    return [list(r.output_tokens) for r in reqs]


def assert_spec_ran(eng):
    snap = eng.metrics.snapshot()
    assert snap.get("spec_rounds", 0) > 0 and eng.metrics.spec_drafted > 0
    assert snap["spec_tokens_per_step"] >= 1.0
    return snap


def quiescent(eng):
    if eng._allocator is not None:
        assert all(s is None for s in eng.slots)
        assert not any(eng._slot_pages)
        eng._allocator.assert_quiescent()


@pytest.fixture(scope="module")
def replay(cfg, params):
    """P + G + P for each of PROMPTS (G = P's 12-token greedy continuation
    on the port's plain engine): after the prompt the n-gram drafter
    proposes G, so every request drafts from its first round."""
    got = gen_all(port_engine(cfg, params), PROMPTS)
    return [p + g + p for p, g in zip(PROMPTS, got)]


@pytest.fixture(scope="module")
def want(jcfg, jparams, replay):
    """The JAX plain engine's greedy tokens for the replay prompts, per KV
    layout (the JAX paged engine with the gather attention)."""
    out = {}
    sp = jengine.SamplingParams(max_new_tokens=16, temperature=0.0)
    for name, kw in LAYOUTS.items():
        if kw:
            kw = dict(kw, paged_attn_impl="gather")
        eng = jengine.LLMEngine(jcfg, JBatchingSpec(**_batching(**kw)),
                                params=jparams)
        reqs = [eng.submit(list(p), sp) for p in replay]
        while not all(r.done.is_set() for r in reqs):
            eng.step()
        out[name] = [list(r.output_tokens) for r in reqs]
    return out


# -- drafting --------------------------------------------------------------------

@pytest.mark.parametrize("ctx,k,nmax,nmin,expect", [
    ([1, 2, 3, 9, 9, 1, 2, 3, 7, 7, 1, 2, 3], 4, 3, 1, [7, 7, 1, 2]),
    ([5, 1, 2, 8, 0, 1, 2, 8], 4, 3, 1, [0, 1, 2, 8]),
    ([1, 2, 3, 4, 5], 4, 3, 1, []),
    ([1, 2, 3, 4, 5, 6, 1, 2], 2, 2, 1, [3, 4])],
    ids=["most-recent", "longer-ngram", "no-match", "truncate-k"])
def test_ngram_propose_cases_equal_jax(ctx, k, nmax, nmin, expect):
    assert tspec.ngram_propose(ctx, k, nmax, nmin) == expect
    assert jspec.ngram_propose(ctx, k, nmax, nmin) == expect


def test_ngram_propose_random_contexts_equal_jax():
    rng = np.random.default_rng(0)
    proposed = 0
    for _ in range(300):
        ctx = rng.integers(0, 6, size=int(rng.integers(1, 40))).tolist()
        k, nmin = int(rng.integers(1, 9)), int(rng.integers(1, 3))
        nmax = nmin + int(rng.integers(0, 3))
        got = tspec.ngram_propose(ctx, k, nmax, nmin)
        assert got == jspec.ngram_propose(ctx, k, nmax, nmin)
        proposed += bool(got)
    assert proposed > 100


# -- verify and draft functions against JAX ----------------------------------------

def _pair(preset):
    jc = jconfig.preset(preset, vocab_size=512, dtype="float32")
    tc = tconfig.preset(preset, vocab_size=512, dtype="float32")
    jp = init_decoder_params(jax.random.PRNGKey(1), jc)
    return jc, tc, jp, params_from_jax(jax.tree.map(np.asarray, jp),
                                       device="cpu")


@pytest.fixture(scope="module", params=["tiny", "tiny-gemma"])
def pair(request):
    return _pair(request.param)


# Four rows: mid-cache, a dead row, one whose verify runs past the cache's
# end (positions 30..34 of 32), and position 0.
LENGTHS = np.array([7, 11, 30, 0])
LIVE = np.array([True, False, True, True])
T = 5


def _verify_inputs(cfg, smax, seed=0):
    rng = np.random.default_rng(seed)
    shape = (cfg.n_layers, len(LENGTHS), smax, cfg.n_kv_heads, cfg.head_dim)
    ck = rng.standard_normal(shape).astype(np.float32)
    cv = rng.standard_normal(shape).astype(np.float32)
    tokens = rng.integers(0, cfg.vocab_size, (len(LENGTHS), T))
    return ck, cv, tokens


def test_verify_step_equals_jax(pair):
    jc, tc, jp, tp = pair
    smax = 32
    ck, cv, tokens = _verify_inputs(tc, smax)
    jids, jcache = jspec.verify_step(
        jp, {"k": jnp.asarray(ck), "v": jnp.asarray(cv)},
        jnp.asarray(tokens, jnp.int32), jnp.asarray(LENGTHS, jnp.int32),
        jnp.asarray(LIVE), jc)
    cache = {"k": torch.tensor(ck), "v": torch.tensor(cv)}
    args = (torch.tensor(tokens), torch.tensor(LENGTHS), torch.tensor(LIVE))
    logits = tspec._verify_logits(tp, {n: c.clone() for n, c in cache.items()},
                                  *args, tc)
    ids = tspec.verify_step(tp, cache, *args, tc)
    live = LIVE.nonzero()[0]
    assert (ids.numpy()[live] == np.asarray(jids)[live]).all()
    assert (logits.argmax(-1) == ids).all()
    for n, src in (("k", ck), ("v", cv)):
        np.testing.assert_allclose(cache[n].numpy(), np.asarray(jcache[n]),
                                   atol=TOL, rtol=0)
        # Untouched: the dead row and every position outside the writes.
        written = np.zeros(src.shape[1:3], bool)
        for b in live:
            written[b, LENGTHS[b]:min(LENGTHS[b] + T, smax)] = True
        np.testing.assert_array_equal(cache[n].numpy()[:, ~written],
                                      src[:, ~written])


def _pool_inputs(cfg, quant, seed=0):
    """A pool of 12 pages of 8 (plus the port's sink), tables of 4 page
    slots: row 2 maps only three (its verify runs off the table), row 1
    is dead."""
    rng = np.random.default_rng(seed)
    pg, npages, mpp = 8, 12, 4
    shape = (cfg.n_layers, npages, pg, cfg.n_kv_heads, cfg.head_dim)
    table = np.full((len(LENGTHS), mpp), -1, np.int32)
    table[0, :2] = [3, 7]
    table[1, :2] = [1, 2]
    table[2, :4] = [0, 5, 9, 11]
    table[3, :1] = [4]
    pool = {}
    if quant:
        for n in ("k", "v"):
            pool[n] = rng.integers(-127, 128, shape).astype(np.int8)
            pool[n + "s"] = rng.uniform(0.005, 0.02, shape[:-1]).astype(
                np.float32)
    else:
        for n in ("k", "v"):
            pool[n] = rng.standard_normal(shape).astype(np.float32)
    tokens = rng.integers(0, cfg.vocab_size, (len(LENGTHS), T))
    return pool, table, tokens


def _with_sink(arr: np.ndarray) -> torch.Tensor:
    pad = np.zeros((arr.shape[0], 1) + arr.shape[2:], arr.dtype)
    return torch.tensor(np.concatenate([arr, pad], axis=1))


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
def test_paged_verify_step_equals_jax(pair, quant):
    jc, tc, jp, tp = pair
    pool, table, tokens = _pool_inputs(tc, quant)
    jcache = {n: jnp.asarray(a) for n, a in pool.items()}
    jcache["table"] = jnp.asarray(table)
    jids, jout = jspec.paged_verify_step(
        jp, jcache, jnp.asarray(tokens, jnp.int32),
        jnp.asarray(LENGTHS, jnp.int32), jnp.asarray(LIVE), jc)
    cache = {n: _with_sink(a) for n, a in pool.items()}
    cache["table"] = torch.tensor(table)
    ids = tspec.paged_verify_step(
        tp, cache, torch.tensor(tokens), torch.tensor(LENGTHS),
        torch.tensor(LIVE), tc, attn_impl="gather")
    live = LIVE.nonzero()[0]
    assert (ids.numpy()[live] == np.asarray(jids)[live]).all()
    if quant:
        for n in ("k", "v"):
            got = dequantize_kv(cache[n][:, :-1], cache[n + "s"][:, :-1],
                                torch.float32)
            ref = np.asarray(jout[n]).astype(np.float32) \
                * np.asarray(jout[n + "s"])[..., None]
            np.testing.assert_allclose(got.numpy(), ref, atol=TOL, rtol=0)
    for n, src in pool.items():
        got = cache[n][:, :-1].numpy()
        if not quant:
            np.testing.assert_allclose(got, np.asarray(jout[n]), atol=TOL,
                                       rtol=0)
        # Pages no live row writes stay as they were (the dead row's
        # pages 1 and 2, and the unused ones).
        untouched = [p for p in range(src.shape[1])
                     if p not in (3, 7, 0, 5, 9, 11, 4)]
        np.testing.assert_array_equal(got[:, untouched], src[:, untouched])


def test_draft_propose_equals_jax(pair):
    jc, tc, jp, tp = pair
    rng = np.random.default_rng(3)
    b, smax, dmax, steps = 4, 32, 5, 8
    shape = (tc.n_layers, b, smax, tc.n_kv_heads, tc.head_dim)
    ck = rng.standard_normal(shape).astype(np.float32)
    cv = rng.standard_normal(shape).astype(np.float32)
    deltas = rng.integers(0, tc.vocab_size, (b, dmax))
    dlens = np.array([1, 5, 3, 2])
    dpos = np.array([4, 0, 27, 9])          # row 2 runs off the cache's end
    live = np.array([True, True, True, False])
    jout, jcache = jspec.draft_propose(
        jp, {"k": jnp.asarray(ck), "v": jnp.asarray(cv)},
        jnp.asarray(deltas, jnp.int32), jnp.asarray(dlens, jnp.int32),
        jnp.asarray(dpos, jnp.int32), jnp.asarray(live), jc, steps)
    cache = {"k": torch.tensor(ck), "v": torch.tensor(cv)}
    out = tspec.draft_propose(tp, cache, torch.tensor(deltas),
                              torch.tensor(dlens), torch.tensor(dpos),
                              torch.tensor(live), tc, steps)
    assert (out.numpy()[live] == np.asarray(jout)[live]).all()
    for n in ("k", "v"):
        np.testing.assert_allclose(cache[n].numpy(), np.asarray(jcache[n]),
                                   atol=TOL, rtol=0)


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
def test_virtual_row_wrapper_equals_gather(cfg, quant):
    """``paged_verify_attention``'s plain path (the paged-decode reference
    over B·T virtual rows, positions clamped to the table's reach) against
    the gather path (pages materialised, then ``_spec_attention``)."""
    pool, table, _ = _pool_inputs(cfg, quant, seed=5)
    gen = torch.Generator().manual_seed(5)
    q = torch.randn((len(LENGTHS), T, cfg.n_heads, cfg.head_dim),
                    generator=gen)
    lengths = torch.tensor(LENGTHS)
    pk, pv = _with_sink(pool["k"][0]), _with_sink(pool["v"][0])
    tab = torch.tensor(table)
    scales = {}
    if quant:
        scales = dict(pool_ks=_with_sink(pool["ks"][0]),
                      pool_vs=_with_sink(pool["vs"][0]))
        ck = dequantize_kv(paged_gather(pk, tab),
                           paged_gather(scales["pool_ks"], tab), torch.float32)
        cv = dequantize_kv(paged_gather(pv, tab),
                           paged_gather(scales["pool_vs"], tab), torch.float32)
    else:
        ck, cv = paged_gather(pk, tab), paged_gather(pv, tab)
    got = paged_verify_attention(q, pk, pv, tab, lengths, **scales)
    ref = tspec._spec_attention(q, ck, cv, lengths, cfg)
    live = torch.tensor(LIVE)              # the dead row's pages are real too
    assert got.shape == ref.shape
    torch.testing.assert_close(got[live], ref[live], atol=TOL, rtol=TOL)


# -- the engine --------------------------------------------------------------------

@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("drafter", ["ngram", "self-draft", "bad-draft"])
def test_engine_tokens_equal_plain_and_jax(cfg, params, replay, want,
                                           layout, drafter):
    spec = {"ngram": NGRAM, "self-draft": SELF_DRAFT,
            "bad-draft": BAD_DRAFT}[drafter]
    draft = params if drafter == "self-draft" else None
    eng = port_engine(cfg, params, spec, draft_params=draft,
                      **LAYOUTS[layout])
    got = gen_all(eng, replay, n=16)
    assert got == want[layout]
    assert got == gen_all(port_engine(cfg, params, **LAYOUTS[layout]),
                          replay, n=16)
    snap = assert_spec_ran(eng)
    if drafter == "self-draft":
        assert snap["spec_acceptance_rate"] > 0.9
        assert snap["spec_tokens_per_step"] > 2.0
    elif drafter == "ngram":
        assert snap["spec_tokens_per_step"] > 1.5
    quiescent(eng)


def test_self_draft_restarts_on_a_reused_slot(cfg, params, replay, want):
    """A slot's next occupant starts the draft's consumed-context pointer
    at 0 (a stale pointer drafts from the previous request's KV, and the
    acceptance collapses)."""
    eng = port_engine(cfg, params, SELF_DRAFT, draft_params=params,
                      max_batch_size=1)
    assert [gen_all(eng, [p], n=16)[0] for p in replay[:2]] == \
        want["dense"][:2]
    assert assert_spec_ran(eng)["spec_acceptance_rate"] > 0.9


def test_sampled_traffic_takes_the_plain_path(cfg, params, replay):
    eng = port_engine(cfg, params, NGRAM, paged=True)
    out = gen_all(eng, replay[:1], n=6, temperature=1.2, top_k=20)
    assert len(out[0]) == 6
    assert "spec_rounds" not in eng.metrics.snapshot()
    # A greedy request beside a sampled one: no spec round while both run,
    # and its greedy tokens are the plain engine's.
    greedy = eng.submit(replay[1], SamplingParams(max_new_tokens=12))
    sampled = eng.submit(replay[2], SamplingParams(
        max_new_tokens=40, temperature=1.0))
    eng.step()                               # admits both
    while not greedy.done.is_set():
        assert eng.metrics.spec_rounds == 0
        eng.step()
    assert greedy.output_tokens == gen_all(port_engine(cfg, params),
                                           [replay[1]])[0]
    while not sampled.done.is_set():
        eng.step()
    quiescent(eng)


def test_stop_token_inside_an_accepted_run(cfg, params, replay, want):
    """The stop token the plain engine stops on, met inside a spec round's
    accepted run, cuts the emission there."""
    ref = want["dense"][1]
    stop = ref[5]
    eng = port_engine(cfg, params, SELF_DRAFT, draft_params=params)
    req = eng.submit(replay[1], SamplingParams(max_new_tokens=50,
                                               stop_token=stop))
    while not req.done.is_set():
        eng.step()
    assert req.output_tokens == ref[:ref.index(stop) + 1]
    assert req.finish_reason == "stop"
    assert eng.metrics.spec_emitted > eng.metrics.spec_rounds


@pytest.mark.parametrize("n", [1, 3, 7])
def test_budget_ends_mid_round(cfg, params, replay, want, n):
    eng = port_engine(cfg, params, SELF_DRAFT, draft_params=params,
                      paged=True)
    assert gen_all(eng, replay[1:2], n=n) == [want["paged"][1][:n]]
    quiescent(eng)


def test_rollback_truncates_the_table(cfg, params, replay):
    """After every spec round, a slot's pages cover exactly ceil(length /
    page); rejected-tail pages were freed (and the pool balances)."""
    eng = port_engine(cfg, params, BAD_DRAFT, paged=True)
    checks = {"rounds": 0, "freed": 0}
    spec_once = eng._spec_decode_once
    truncate = eng._truncate_slot_pages

    def counted_truncate(idx, keep):
        before = len(eng._slot_pages[idx])
        truncate(idx, keep)
        checks["freed"] += before - len(eng._slot_pages[idx])

    def checked(active):
        out = spec_once(active)
        checks["rounds"] += 1
        for i, s in enumerate(eng.slots):
            if s is not None:
                assert len(eng._slot_pages[i]) == -(-s.length // 16)
                assert (eng._table[i, len(eng._slot_pages[i]):] == -1).all()
        return out

    eng._spec_decode_once = checked
    eng._truncate_slot_pages = counted_truncate
    gen_all(eng, replay, n=30)
    assert checks["rounds"] > 0 and checks["freed"] > 0
    quiescent(eng)


def test_prefix_pages_survive_rollback(cfg, params, replay):
    """Rollback never frees a registered prompt page: the same prompt again
    hits the prefix index and gives the same tokens."""
    eng = port_engine(cfg, params, NGRAM, paged=True)
    first = gen_all(eng, replay[1:2])
    hits = eng._allocator.stats["prefix_hits"]
    assert_spec_ran(eng)
    assert gen_all(eng, replay[1:2]) == first
    assert eng._allocator.stats["prefix_hits"] == hits + 1
    quiescent(eng)


@pytest.mark.parametrize("kv", [None, "int8"], ids=["float", "int8"])
def test_decode_role_runs_spec_rounds_on_adopted_requests(cfg, params,
                                                          replay, kv):
    pre = port_engine(cfg, params, role="prefill", paged=True,
                      kv_cache_dtype=kv)
    dec = port_engine(cfg, params, NGRAM, role="decode", paged=True,
                      kv_cache_dtype=kv)
    ref = gen_all(port_engine(cfg, params, paged=True, kv_cache_dtype=kv),
                  replay[1:2], n=16)[0]
    p_req = pre.submit(replay[1], SamplingParams(max_new_tokens=16))
    while not p_req.done.is_set():
        pre.step()
    assert p_req.finish_reason == "handoff"
    d_req = dec.submit_handoff(HandoffPayload.from_wire(
        p_req.handoff.to_wire()))
    while not d_req.done.is_set():
        dec.step()
    pre.complete_handoff(p_req.id)
    pre.step()
    assert [p_req.handoff.first_token] + d_req.output_tokens == ref
    assert_spec_ran(dec)
    quiescent(pre)
    quiescent(dec)


# -- configuration ----------------------------------------------------------------

def test_speculative_off_and_a_jax_dump_are_accepted(cfg, params):
    assert BatchingSpec(speculative={"mode": "off"}).speculative.mode == "off"
    assert BatchingSpec(speculative=None).speculative == SpeculativeSpec()
    dump = JBatchingSpec(max_batch_size=2, max_seq_len=64,
                         prefill_buckets=[16]).model_dump()["speculative"]
    assert dump["mode"] == "off"
    eng = LLMEngine(cfg, BatchingSpec(max_batch_size=2, max_seq_len=64,
                                      prefill_buckets=[16],
                                      speculative=dump),
                    params=params, device="cpu")
    assert eng.spec_mode == "off"
    spec = JSpeculativeSpec(mode="ngram", k=6).model_dump()
    eng = LLMEngine(cfg, BatchingSpec(max_batch_size=2, max_seq_len=64,
                                      prefill_buckets=[16],
                                      speculative=spec),
                    params=params, device="cpu")
    assert (eng.spec_mode, eng.spec_k) == ("ngram", 6)


@pytest.mark.parametrize("kw", [
    dict(speculative=dict(mode="medusa")),
    dict(speculative=dict(mode="ngram", k=0)),
    dict(speculative=dict(mode="draft_model", k=65)),
    dict(speculative=dict(mode="ngram", ngram_min=0)),
    dict(speculative=dict(mode="ngram", ngram_min=3, ngram_max=2)),
    dict(speculative=dict(mode="ngram"), lora=dict(max_adapters=2))],
    ids=["mode", "k0", "k65", "ngram-min0", "ngram-order", "lora"])
def test_spec_errors_equal_jax(kw):
    with pytest.raises(ValueError) as jexc:
        JBatchingSpec(**kw)
    with pytest.raises(ValueError) as texc:
        BatchingSpec(**kw)
    assert str(texc.value) in str(jexc.value)


def test_draft_vocab_mismatch_is_refused(cfg, params):
    with pytest.raises(ValueError, match="vocab"):
        port_engine(cfg, params, {"mode": "draft_model",
                                  "draft": {"preset": "tiny"}})


def test_spec_beside_the_host_tier_constructs(cfg):
    eng = LLMEngine(cfg, BatchingSpec(**_batching(
        speculative=NGRAM, paged=True, kv_cache_dtype="int8",
        host_kv_pages=8)), device="cpu")
    try:
        assert eng.spec_mode == "ngram"
    finally:
        assert eng.stop()


# -- the worker -------------------------------------------------------------------

def test_worker_serves_with_speculative(cfg):
    """``runtime.worker_main`` → ``model_server`` with
    ``batching.speculative`` ngram on the page pool: the completion's text
    is an in-process spec engine's on the same (``random://``) weights,
    which ran spec rounds, and /metrics shows the spec gauges."""
    batching = _batching(paged=True, speculative=NGRAM)
    tok = ByteTokenizer()
    prompt = "abc" * 3
    ref = LLMEngine(cfg, BatchingSpec(**batching), seed=0, device="cpu")
    [tokens] = gen_all(ref, [tok.encode(prompt)], n=24)
    assert_spec_ran(ref)
    port = free_port()
    wenv = WorkerEnv(
        coordinator_address="127.0.0.1:0", num_processes=1, process_id=0,
        job="default/spec", replica_index=0, entrypoint="model_server",
        config={"model": {"preset": "tiny", "overrides": {
            "vocab_size": 512, "dtype": "float32"}},
            "storage_uri": "random://", "batching": batching, "port": port,
            "service": "tiny"},
        parallelism={}, platform="cpu")
    env = {k: v for k, v in os.environ.items() if not k.startswith("KFTPU_")}
    env.update(wenv.to_env())
    env["PYTHONPATH"] = str(REPO)
    proc = subprocess.Popen(
        [sys.executable, "-m", "kubeflow_tpu_torch.runtime.worker_main"],
        cwd=REPO, env=env, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, text=True)
    url = f"http://127.0.0.1:{port}"
    try:
        t0 = time.monotonic()
        while True:
            assert proc.poll() is None, proc.stderr.read()[-2000:]
            assert time.monotonic() - t0 < 90, "worker never became ready"
            try:
                with urllib.request.urlopen(url + "/v2/health/ready",
                                            timeout=2) as r:
                    if r.status == 200:
                        break
            except OSError:
                time.sleep(0.2)
        body = json.dumps({"prompt": prompt, "max_tokens": 24}).encode()
        req = urllib.request.Request(url + "/v1/completions", data=body,
                                     headers={"Content-Type":
                                              "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            out = json.loads(r.read())
        assert out["choices"][0]["text"] == tok.decode(tokens)
        with urllib.request.urlopen(url + "/metrics", timeout=10) as r:
            metrics = r.read().decode()
        for name in ("spec_tokens_per_step", "spec_acceptance_rate",
                     "spec_draft_overhead"):
            assert f"kftpu_serving_{name}{{" in metrics, name
    finally:
        proc.kill()
        proc.wait(timeout=30)
