"""The port's KV handoff (``kubeflow_tpu_torch/serve/handoff.py`` and the
engine roles) on the CPU, held to the JAX package on the same weights and
inputs:

- the wire format: ``to_wire`` and ``pages_to_wire`` bytes equal the JAX
  encoder's for the same fp32, int8 + scale and bf16 arrays (bf16 built
  with ``ml_dtypes`` here only: the port carries it as uint16 bits), each
  package decodes the other's bytes to the same values, and truncated or
  malformed blobs are refused as in ``tests/test_serve_handoff.py``;
- greedy tokens, exactly: port prefill → wire → port decode equals the
  port's unified engine and the JAX unified engine, dense, paged and int8
  paged; a JAX prefill engine's payload bytes adopted by a port decode
  engine, and a port export adopted by a JAX decode engine, both give the
  JAX unified engine's tokens;
- page ownership: the hold is released only on the ack, the fail and reap
  paths free it, a prefill role finishes one-token requests locally,
  ``handoff=False`` decodes locally, adopted pages register their prefix
  (float and int8 pools), and shape, budget and cache-dtype mismatches are
  refused."""

import dataclasses
import time

import numpy as np
import pytest

jax = pytest.importorskip("jax")
ml_dtypes = pytest.importorskip("ml_dtypes")

from kubeflow_tpu.core.serving import BatchingSpec as JBatchingSpec  # noqa: E402
from kubeflow_tpu.models import config as jconfig  # noqa: E402
from kubeflow_tpu.models import decoder as jdec  # noqa: E402
from kubeflow_tpu.serve import engine as jengine  # noqa: E402
from kubeflow_tpu.serve import handoff as jhandoff  # noqa: E402
from kubeflow_tpu_torch.core.serving import BatchingSpec  # noqa: E402
from kubeflow_tpu_torch.models import config as tconfig  # noqa: E402
from kubeflow_tpu_torch.models.convert import params_from_jax  # noqa: E402
from kubeflow_tpu_torch.serve import handoff as thandoff  # noqa: E402
from kubeflow_tpu_torch.serve.engine import LLMEngine, SamplingParams  # noqa: E402
from kubeflow_tpu_torch.serve.handoff import HandoffPayload  # noqa: E402
from port_threads import torch_on_one_thread  # noqa: E402,F401

JCFG = jconfig.preset("tiny", vocab_size=512, dtype="float32")
CFG = tconfig.preset("tiny", vocab_size=512, dtype="float32")
JPARAMS = jdec.init_decoder_params(jax.random.PRNGKey(0), JCFG)
PARAMS = params_from_jax(jax.tree.map(np.asarray, JPARAMS), device="cpu")

PROMPTS = [list(range(3, 23)), [7, 9, 11] * 9, list(range(40, 45))]
MODES = {"dense": {}, "paged": {"paged": True},
         "int8": {"paged": True, "kv_cache_dtype": "int8"}}
GREEDY = dict(max_new_tokens=12, temperature=0.0)


def spec(role="unified", **kw):
    base = dict(max_batch_size=2, max_seq_len=96, prefill_buckets=[32],
                chunked_prefill_tokens=16, decode_steps=4, role=role)
    if kw.get("paged"):
        base["page_size"] = 16
    base.update(kw)
    return base


def engine(role="unified", **kw):
    return LLMEngine(CFG, BatchingSpec(**spec(role, **kw)), params=PARAMS,
                     device="cpu")


def jax_engine(role="unified", **kw):
    return jengine.LLMEngine(JCFG, JBatchingSpec(**spec(role, **kw)),
                             params=JPARAMS)


def drive(eng, req, timeout=60.0):
    deadline = time.monotonic() + timeout
    while not req.done.is_set():
        eng.step()
        assert time.monotonic() < deadline, "request never finished"
    return req


def drain(eng, timeout=30.0):
    deadline = time.monotonic() + timeout
    while (eng.kv_pages_in_use() > 0 or eng._rounds
           or eng._handoff_holds):
        eng.step()
        assert time.monotonic() < deadline, "engine did not quiesce"


def quiescent(*engines):
    for e in engines:
        drain(e)
        if e._allocator is not None:
            e._allocator.assert_quiescent()
            assert e._allocator.leak_report_by_owner() == {}


# -- the wire format -------------------------------------------------------------

def _arrays(kind, shape=(2, 3, 2, 4), seed=0):
    """(JAX-side arrays, port-side arrays): k, v and, for int8, the scale
    rows. bf16 is ml_dtypes on the JAX side, its uint16 bits on the
    port's."""
    r = np.random.default_rng(seed)
    k = r.standard_normal(shape).astype(np.float32)
    v = r.standard_normal(shape).astype(np.float32)
    if kind == "float32":
        return (k, v, None, None), (k, v, None, None)
    if kind == "bfloat16":
        jk, jv = k.astype(ml_dtypes.bfloat16), v.astype(ml_dtypes.bfloat16)
        return (jk, jv, None, None), (jk.view(np.uint16), jv.view(np.uint16),
                                      None, None)
    k8 = np.clip(np.round(k * 40), -127, 127).astype(np.int8)
    v8 = np.clip(np.round(v * 40), -127, 127).astype(np.int8)
    sk = r.random(shape[:-1], np.float32) + 0.1
    sv = sk * 2
    return (k8, v8, sk, sv), (k8, v8, sk, sv)


META = dict(request_id="w", prompt_tokens=[1, 2, 3], first_token=4,
            max_new_tokens=5, temperature=0.7, top_k=3, top_p=0.9,
            stop_token=2, qos="interactive")


def _payloads(kind):
    (jk, jv, jsk, jsv), (tk, tv, tsk, tsv) = _arrays(kind)
    return (jhandoff.HandoffPayload(kv_k=jk, kv_v=jv, kv_scale_k=jsk,
                                    kv_scale_v=jsv, **META),
            HandoffPayload(kv_k=tk, kv_v=tv, kv_scale_k=tsk, kv_scale_v=tsv,
                           **META))


KINDS = ("float32", "int8", "bfloat16")


@pytest.mark.parametrize("kind", KINDS)
def test_payload_wire_bytes_equal_jax(kind):
    jp, tp = _payloads(kind)
    assert tp.to_wire() == jp.to_wire()
    assert tp.wire_bytes == jp.wire_bytes
    assert tp.cache_dtype == jp.cache_dtype


@pytest.mark.parametrize("kind", KINDS)
def test_pages_wire_bytes_equal_jax(kind):
    (jk, jv, jsk, jsv), (tk, tv, tsk, tsv) = _arrays(kind, (2, 4, 2, 8), 1)
    want = jhandoff.pages_to_wire(jk, jv, kv_sk=jsk, kv_sv=jsv)
    assert thandoff.pages_to_wire(tk, tv, kv_sk=tsk, kv_sv=tsv) == want
    # Each package decodes the other's bytes to the same bits.
    got = thandoff.pages_from_wire(want)
    back = jhandoff.pages_from_wire(
        thandoff.pages_to_wire(tk, tv, kv_sk=tsk, kv_sv=tsv))
    for g, t, b, j in zip(got, (tk, tv, tsk, tsv), back, (jk, jv, jsk, jsv)):
        if t is None:
            assert g is None and b is None
            continue
        assert g.dtype == t.dtype and np.array_equal(g, t)
        assert b.dtype == j.dtype and b.tobytes() == j.tobytes()


@pytest.mark.parametrize("kind", KINDS)
def test_from_wire_of_jax_bytes(kind):
    jp, tp = _payloads(kind)
    got = HandoffPayload.from_wire(jp.to_wire())
    for f in META:
        assert getattr(got, f) == getattr(tp, f)
    for f in ("kv_k", "kv_v", "kv_scale_k", "kv_scale_v"):
        g, t = getattr(got, f), getattr(tp, f)
        if t is None:
            assert g is None
        else:
            assert g.dtype == t.dtype and np.array_equal(g, t)
    back = jhandoff.HandoffPayload.from_wire(tp.to_wire())
    assert back.kv_k.dtype == jp.kv_k.dtype
    assert back.kv_k.tobytes() == jp.kv_k.tobytes()


def test_bf16_host_arrays_round_trip_through_torch():
    import torch

    t = torch.randn(2, 5, 3, dtype=torch.float32).to(torch.bfloat16)
    a = thandoff.host_array(t)
    assert a.dtype == np.uint16
    assert a.tobytes() == np.asarray(
        t.float().numpy().astype(ml_dtypes.bfloat16)).tobytes()
    back = thandoff.to_torch(a)
    assert back.dtype == torch.bfloat16 and torch.equal(back, t)


def test_wire_v2_rejects_malformed_scales():
    kv8 = np.ones((1, 2, 1, 4), np.int8)
    sc = np.ones((1, 2, 1), np.float32)
    base = dict(request_id="w", prompt_tokens=[1, 2], first_token=3,
                max_new_tokens=2, temperature=0.0, top_k=0, top_p=1.0,
                stop_token=None, qos="standard")
    with pytest.raises(ValueError, match="pair"):
        HandoffPayload(kv_k=kv8, kv_v=kv8, kv_scale_k=sc, **base).validate()
    with pytest.raises(ValueError, match="int8"):
        HandoffPayload(kv_k=kv8.astype(np.float32),
                       kv_v=kv8.astype(np.float32),
                       kv_scale_k=sc, kv_scale_v=sc, **base).validate()
    with pytest.raises(ValueError, match="scale"):
        HandoffPayload(kv_k=kv8, kv_v=kv8, kv_scale_k=sc[:, :1],
                       kv_scale_v=sc[:, :1], **base).validate()
    good = HandoffPayload(kv_k=kv8, kv_v=kv8, kv_scale_k=sc,
                          kv_scale_v=sc, **base)
    with pytest.raises(ValueError, match="truncated"):
        HandoffPayload.from_wire(good.to_wire()[:-2])


def test_wire_format_rejects_truncation():
    payload = HandoffPayload(
        request_id="w", prompt_tokens=[1, 2], first_token=3,
        max_new_tokens=2, temperature=0.0, top_k=0, top_p=1.0,
        stop_token=None, qos="standard",
        kv_k=np.ones((1, 2, 1, 4), np.float32),
        kv_v=np.ones((1, 2, 1, 4), np.float32))
    wire = payload.to_wire()
    back = HandoffPayload.from_wire(wire)
    assert back.prompt_tokens == [1, 2]
    assert np.array_equal(back.kv_k, payload.kv_k)
    with pytest.raises(ValueError, match="truncated"):
        HandoffPayload.from_wire(wire[:-3])
    with pytest.raises(ValueError, match="metadata"):
        HandoffPayload.from_wire(b"")


# -- greedy identity ------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_side():
    """Per mode: the JAX unified engine's greedy tokens for PROMPTS, and a
    JAX prefill engine's payload bytes for each prompt."""
    out = {}
    params = jengine.SamplingParams(**GREEDY)
    for mode, kw in MODES.items():
        uni = jax_engine(**kw)
        pre = jax_engine("prefill", **kw)
        want, wires = [], []
        for p in PROMPTS:
            want.append(uni.generate(p, params))
            r = drive(pre, pre.submit(p, params))
            assert r.finish_reason == "handoff"
            wires.append(r.handoff.to_wire())
            pre.complete_handoff(r.id)
        out[mode] = (want, wires)
    return out


@pytest.mark.parametrize("mode", list(MODES))
def test_greedy_token_identity_across_handoff(mode, jax_side):
    """port prefill → wire → port decode == the port's unified engine ==
    the JAX unified engine, token for token."""
    kw = MODES[mode]
    uni, pre, dec = engine(**kw), engine("prefill", **kw), \
        engine("decode", **kw)
    params = SamplingParams(**GREEDY)
    for prompt, jwant in zip(PROMPTS, jax_side[mode][0]):
        want = uni.generate(prompt, params)
        assert want == jwant
        p_req = drive(pre, pre.submit(prompt, params))
        assert p_req.finish_reason == "handoff"
        payload = p_req.handoff
        assert payload.first_token == want[0]
        assert payload.kv_len == len(prompt)
        assert payload.cache_dtype == ("int8" if mode == "int8" else None)
        assert pre._handoff_holds or not kw     # paged: held until the ack
        payload = HandoffPayload.from_wire(payload.to_wire())
        d_req = drive(dec, dec.submit_handoff(payload))
        assert d_req.finish_reason in ("stop", "length")
        assert [payload.first_token] + d_req.output_tokens == want
        pre.complete_handoff(p_req.id)
    snap_p, snap_d = pre.metrics.snapshot(), dec.metrics.snapshot()
    assert snap_p["handoffs_exported"] == snap_d["handoffs_adopted"] == 3
    assert snap_p["handoff_bytes_exported"] == \
        snap_d["handoff_bytes_adopted"] > 0
    quiescent(pre, dec, uni)


@pytest.mark.parametrize("mode", list(MODES))
def test_jax_export_adopted_by_port(mode, jax_side):
    want, wires = jax_side[mode]
    dec = engine("decode", **MODES[mode])
    for w, jwant in zip(wires, want):
        payload = HandoffPayload.from_wire(w)
        d_req = drive(dec, dec.submit_handoff(payload))
        assert [payload.first_token] + d_req.output_tokens == jwant
    quiescent(dec)


@pytest.mark.parametrize("mode", list(MODES))
def test_port_export_adopted_by_jax(mode, jax_side):
    want = jax_side[mode][0]
    kw = MODES[mode]
    pre, jdec_eng = engine("prefill", **kw), jax_engine("decode", **kw)
    params = SamplingParams(**GREEDY)
    for prompt, jwant in zip(PROMPTS, want):
        p_req = drive(pre, pre.submit(prompt, params))
        payload = jhandoff.HandoffPayload.from_wire(p_req.handoff.to_wire())
        d_req = drive(jdec_eng, jdec_eng.submit_handoff(payload))
        assert [payload.first_token] + d_req.output_tokens == jwant
        pre.complete_handoff(p_req.id)
    quiescent(pre)


# -- ownership ----------------------------------------------------------------

def test_handoff_hold_released_only_on_ack(monkeypatch):
    monkeypatch.setenv("KFTPU_SANITIZE", "refcount")
    pre = engine("prefill", paged=True)
    req = drive(pre, pre.submit(PROMPTS[0], SamplingParams(max_new_tokens=8)))
    assert req.finish_reason == "handoff"
    for _ in range(3):
        pre.step()
    assert pre.kv_pages_in_use() > 0, "the hold should reference pages"
    assert req.id in pre._handoff_holds
    assert set(pre._allocator.leak_report_by_owner()) == {req.id}
    pre.complete_handoff(req.id)
    quiescent(pre)
    assert pre.metrics.snapshot()["handoffs_failed"] == 0


def test_handoff_failure_and_reap_paths_free_pages():
    pre = engine("prefill", paged=True)
    r1 = drive(pre, pre.submit(PROMPTS[0], SamplingParams(max_new_tokens=8)))
    pre.fail_handoff(r1.id)
    drain(pre)
    assert pre.metrics.snapshot()["handoffs_failed"] == 1
    # An abandoned hold (the server died before any ack): the reaper.
    r2 = drive(pre, pre.submit(PROMPTS[1], SamplingParams(max_new_tokens=8)))
    assert pre.kv_pages_in_use() > 0
    r2.cancel()
    quiescent(pre)
    assert pre.metrics.snapshot()["handoffs_failed"] == 2


def test_prefill_role_finishes_short_requests_locally():
    pre = engine("prefill", paged=True)
    req = drive(pre, pre.submit(PROMPTS[0], SamplingParams(max_new_tokens=1)))
    assert req.finish_reason == "length"
    assert req.handoff is None
    assert len(req.output_tokens) == 1
    quiescent(pre)
    assert pre.metrics.snapshot()["handoffs_exported"] == 0


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_unified_fallback_submit_on_prefill_engine(paged):
    kw = {"paged": True} if paged else {}
    uni, pre = engine(**kw), engine("prefill", **kw)
    params = SamplingParams(**GREEDY)
    want = uni.generate(PROMPTS[0], params)
    req = drive(pre, pre.submit(PROMPTS[0], params, handoff=False))
    assert req.finish_reason in ("stop", "length")
    assert req.output_tokens == want
    quiescent(pre)


@pytest.mark.parametrize("quant", [None, "int8"], ids=["float", "int8"])
def test_adopted_pages_register_prefix_for_reuse(quant):
    pre = engine("prefill", paged=True, kv_cache_dtype=quant)
    dec = engine("decode", paged=True, kv_cache_dtype=quant)
    prompt = list(range(1, 33))          # two full 16-token pages
    params = SamplingParams(max_new_tokens=6, temperature=0.0)
    p1 = drive(pre, pre.submit(prompt, params))
    d1 = drive(dec, dec.submit_handoff(HandoffPayload.from_wire(
        p1.handoff.to_wire())))
    pre.complete_handoff(p1.id)
    hits_before = dec._allocator.stats["prefix_hits"]
    p2 = drive(pre, pre.submit(prompt, params, request_id="again"))
    d2 = drive(dec, dec.submit_handoff(p2.handoff))
    pre.complete_handoff(p2.id)
    assert dec._allocator.stats["prefix_hits"] > hits_before
    assert d2.output_tokens == d1.output_tokens
    quiescent(pre, dec)


def test_adoption_rejects_shape_and_budget_mismatch():
    dec = engine("decode", paged=True)
    good = HandoffPayload(
        request_id="x", prompt_tokens=[1, 2, 3], first_token=4,
        max_new_tokens=4, temperature=0.0, top_k=0, top_p=1.0,
        stop_token=None, qos="standard",
        kv_k=np.zeros((CFG.n_layers, 3, CFG.n_kv_heads, CFG.head_dim),
                      np.float32),
        kv_v=np.zeros((CFG.n_layers, 3, CFG.n_kv_heads, CFG.head_dim),
                      np.float32))
    with pytest.raises(ValueError, match="budget"):
        dec.submit_handoff(dataclasses.replace(good, max_new_tokens=0))
    with pytest.raises(ValueError, match="shape"):
        dec.submit_handoff(dataclasses.replace(
            good, kv_k=good.kv_k[:, :, :1], kv_v=good.kv_v[:, :, :1]))
    long_kv = np.zeros((CFG.n_layers, 95, CFG.n_kv_heads, CFG.head_dim),
                       np.float32)
    with pytest.raises(ValueError, match="max_seq_len"):
        dec.submit_handoff(dataclasses.replace(
            good, prompt_tokens=[1] * 95, kv_k=long_kv, kv_v=long_kv))
    assert dec.queue_depth() == 0


def test_adoption_rejects_cache_dtype_mismatch():
    pre8 = engine("prefill", paged=True, kv_cache_dtype="int8")
    pre16 = engine("prefill", paged=True)
    dec8 = engine("decode", paged=True, kv_cache_dtype="int8")
    dec16 = engine("decode", paged=True)
    params = SamplingParams(max_new_tokens=4, temperature=0.0)
    p8 = drive(pre8, pre8.submit(PROMPTS[0], params))
    p16 = drive(pre16, pre16.submit(PROMPTS[0], params))
    with pytest.raises(ValueError, match="cache-dtype mismatch"):
        dec16.submit_handoff(p8.handoff)
    with pytest.raises(ValueError, match="cache-dtype mismatch"):
        dec8.submit_handoff(p16.handoff)
    drive(dec8, dec8.submit_handoff(p8.handoff))
    drive(dec16, dec16.submit_handoff(p16.handoff))
    pre8.complete_handoff(p8.id)
    pre16.complete_handoff(p16.id)
    quiescent(pre8, pre16, dec8, dec16)
    # int8 pages + scale rows ride in fewer bytes than the float pages.
    assert p8.handoff.wire_bytes < p16.handoff.wire_bytes * 0.8


def test_preempted_adoption_resumes_by_recompute():
    """Pool pressure on the decode engine preempts an adopted request: it
    resumes by recompute over prompt + first token + decoded tokens (not by
    adopting the payload's KV again) and still gives the unified engine's
    tokens, with no token repeated and no page left referenced."""
    uni, pre = engine(paged=True), engine("prefill", paged=True)
    dec = engine("decode", paged=True, max_pages=7)   # 6 pages = one slot
    params = SamplingParams(max_new_tokens=40, temperature=0.0)
    prompts = [list(range(3, 23)), list(range(60, 80))]
    want = [uni.generate(p, params) for p in prompts]
    payloads = []
    for p in prompts:
        r = drive(pre, pre.submit(p, params))
        payloads.append(HandoffPayload.from_wire(r.handoff.to_wire()))
        pre.complete_handoff(r.id)
    reqs = [dec.submit_handoff(pl) for pl in payloads]
    for r in reqs:
        drive(dec, r)
    assert dec.metrics.snapshot()["preemptions"] >= 1
    for pl, r, w in zip(payloads, reqs, want):
        assert [pl.first_token] + r.output_tokens == w
    quiescent(pre, dec)
