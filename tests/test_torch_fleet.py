"""The port's fleet-wide KV fabric over real HTTP model servers on the CPU
(the port of ``tests/test_serve_fleet.py``): conversation failover through
the remote KV tier and the router, the cross-host handoff's ack-loss
recompute and retry onto an alternate, the mixed-version negotiation
guard — and failover across packages, where a JAX server spills and dies
and a port server on the same store root serves the next turn.

The gate: kill the engine that holds a multi-turn conversation, and the
next turn lands on a survivor, adopts the stored prefix from the artifact
store (the store-hit counters above zero) and produces the tier-free
reference's tokens, while every injected handoff fault degrades to a local
recompute with the request still resolving, and both pools balance their
refcounts afterwards."""

import time
import urllib.error
import urllib.request

import pytest

from fleet_support import audit_quiescent, completion_text, dead_url, stop_all
from kubeflow_tpu_torch.core.headers import (
    DECODE_ALTS_HEADER, DECODE_BACKEND_HEADER, HANDOFF_DTYPE_HEADER,
    HANDOFF_WIRE_HEADER,
)
from kubeflow_tpu_torch.core.serving import BatchingSpec
from kubeflow_tpu_torch.models.config import preset
from kubeflow_tpu_torch.serve.engine import LLMEngine
from kubeflow_tpu_torch.serve.faults import ChaosProxy, kill_model_server
from kubeflow_tpu_torch.serve.router import Router
from kubeflow_tpu_torch.serve.server import ModelServer
from port_threads import torch_on_one_thread  # noqa: F401

CFG = preset("tiny", vocab_size=512, dtype="float32")   # byte tokenizer fits
TURN1 = "fleet failover: the conversation must survive the host"
SPEC = dict(max_batch_size=2, max_seq_len=96, prefill_buckets=[32],
            paged=True, page_size=16, chunked_prefill_tokens=16,
            decode_steps=4)


def spec(role="unified", *, remote_root=None, prefix=True):
    kw = {}
    if remote_root is not None:
        kw.update(host_kv_pages=64, kv_demote_after_s=0.05,
                  kv_remote_after_s=0.05, remote_kv_root=str(remote_root),
                  prefix_index="radix")
    return BatchingSpec(**SPEC, enable_prefix_caching=prefix, role=role, **kw)


def mk_server(name, sp, params=None):
    srv = ModelServer(name, LLMEngine(CFG, sp, params=params, seed=0,
                                      device="cpu"))
    srv.start()
    return srv


def wait_spilled(eng, pages: int, deadline_s: float = 20.0) -> None:
    """The idle engine's tier scan demotes the released conversation to
    host RAM, then spills it into the store."""
    deadline = time.monotonic() + deadline_s
    while eng.kv_tier_stats().get("pages_demoted_remote", 0) < pages:
        time.sleep(0.02)
        assert time.monotonic() < deadline, \
            f"no remote spill happened: {eng.kv_tier_stats()}"


def assert_store_hit(eng, pages: int = 3) -> None:
    tier = eng.kv_tier_stats()
    assert tier["remote_registry_hits"] > 0, tier
    assert tier["pages_promoted_remote"] >= pages, tier
    assert tier["prefix_hits"] >= 1, tier


def test_failover_sigkill_then_resume_on_survivor_through_the_router(
        tmp_path, monkeypatch):
    """Turn 1 lands on replica A through the router, the conversation goes
    idle and spills; A is killed; turn 2 through the router retries onto
    B (same store root, no connection to A ever) and adopts the stored
    prefix — the tier-free reference's text, the store-hit counters up,
    refcounts exact under the sanitizer."""
    monkeypatch.setenv("KFTPU_SANITIZE", "refcount")
    a = mk_server("fleet-a", spec(remote_root=tmp_path))
    b = mk_server("fleet-b", spec(remote_root=tmp_path))
    ref = mk_server("fleet-ref", spec(prefix=False))
    router = Router(queue_timeout=5.0, eject_threshold=2, eject_period=5.0,
                    max_retries=2, upstream_timeout=30.0)
    router.set_backends({"latest": [a.url]})
    router.start()
    try:
        assert a.engine._allocator.refcount_debug
        st, text1 = completion_text(router.url, TURN1)
        assert st == 200
        st, want1 = completion_text(ref.url, TURN1)
        assert st == 200 and text1 == want1
        wait_spilled(a.engine, 3)
        router.set_backends({"latest": [a.url, b.url]})
        kill_model_server(a)
        turn2 = TURN1 + text1 + " and then"
        for _ in range(2):      # one of the two lands on A first: a retry
            st, text2 = completion_text(router.url, turn2)
            assert st == 200
            st, want2 = completion_text(ref.url, turn2)
            assert st == 200 and text2 == want2
        assert_store_hit(b.engine)
        assert router.snapshot()["connect_failures"] >= 1
        audit_quiescent(b, ref)
        for srv in (b, ref):
            assert srv.engine._allocator.leak_report_by_owner() == {}
    finally:
        router.stop()
        stop_all(a, b, ref)


def test_decode_ack_loss_mid_adoption_recomputes(monkeypatch):
    """A dropped handoff ack after the decode side adopted: the prefill
    side takes the terminal fallback — local recompute, the same greedy
    text — and both pools balance, the decode side's orphaned adoption
    included."""
    monkeypatch.setenv("KFTPU_SANITIZE", "refcount")
    pre = mk_server("pre-a", spec("prefill"))
    dec = mk_server("dec-b", spec("decode"))
    proxy = ChaosProxy(dec.url)
    proxy.start()
    try:
        prompt = "handoff ack loss: the request must still resolve"
        hdr = [(DECODE_BACKEND_HEADER, proxy.url)]
        st, want = completion_text(pre.url, prompt, headers=hdr)
        assert st == 200
        assert pre.engine.metrics.snapshot()["handoffs_exported"] >= 1
        assert dec.engine.metrics.snapshot()["handoffs_adopted"] >= 1
        proxy.drop_response()
        st, got = completion_text(pre.url, prompt, headers=hdr)
        assert st == 200 and got == want
        snap = pre.engine.metrics.snapshot()
        assert snap["handoffs_fallback"] >= 1, snap
        assert proxy.stats["responses_dropped"] >= 1
        proxy.undrop_response()
        audit_quiescent(pre, dec)
        for srv in (pre, dec):
            assert srv.engine._allocator.leak_report_by_owner() == {}
    finally:
        proxy.stop()
        stop_all(pre, dec)


def test_handoff_retry_lands_on_alternate_replica():
    """A dead primary decode replica and a router-stamped alternate: the
    bounded retry targets the other replica and the handoff completes
    there — counted in handoffs_retried, no fallback."""
    pre = mk_server("pre-a", spec("prefill"))
    dec = mk_server("dec-b", spec("decode"))
    try:
        st, text = completion_text(
            pre.url, "retry onto the alternate decode replica",
            headers=[(DECODE_BACKEND_HEADER, dead_url()),
                     (DECODE_ALTS_HEADER, dec.url)])
        assert st == 200 and text
        snap = pre.engine.metrics.snapshot()
        assert snap["handoffs_retried"] >= 1, snap
        assert snap["handoffs_fallback"] == 0, snap
        assert dec.engine.metrics.snapshot()["handoffs_adopted"] >= 1
        audit_quiescent(pre, dec)
    finally:
        stop_all(pre, dec)


def test_handoff_negotiation_rejects_409():
    """An unsupported wire version or a cache-dtype mismatch answers 409
    before the payload's bytes are read."""
    dec = mk_server("dec-b", spec("decode"))
    try:
        def post_handoff(headers):
            req = urllib.request.Request(
                dec.url + "/v1/handoff", data=b"",
                headers={"Content-Type": "application/octet-stream",
                         **headers})
            try:
                with urllib.request.urlopen(req, timeout=10) as r:
                    return r.status, r.read().decode()
            except urllib.error.HTTPError as exc:
                return exc.code, exc.read().decode(errors="replace")

        st, body = post_handoff({HANDOFF_WIRE_HEADER: "99"})
        assert st == 409 and "wire version" in body
        st, body = post_handoff({HANDOFF_WIRE_HEADER: "2",
                                 HANDOFF_DTYPE_HEADER: "int8"})
        assert st == 409 and "dtype" in body
        audit_quiescent(dec)
    finally:
        stop_all(dec)


def test_jax_server_spills_and_dies_port_server_serves_turn_2(tmp_path):
    """Failover across packages on one store root: a JAX ModelServer
    serves turn 1, spills it and is killed; a port ModelServer on the same
    root, with the same weights through ``params_from_jax``, serves turn 2
    with the JAX unified engine's text and adopts the prefix from the
    store."""
    jax = pytest.importorskip("jax")
    import numpy as np
    from kubeflow_tpu.core.serving import BatchingSpec as JBatchingSpec
    from kubeflow_tpu.models import config as jconfig
    from kubeflow_tpu.models import decoder as jdec
    from kubeflow_tpu.serve import engine as jengine
    from kubeflow_tpu.serve import faults as jfaults
    from kubeflow_tpu.serve import server as jserver
    from kubeflow_tpu_torch.models.convert import params_from_jax

    jcfg = jconfig.preset("tiny", vocab_size=512, dtype="float32")
    jparams = jdec.init_decoder_params(jax.random.PRNGKey(0), jcfg)
    tier = dict(host_kv_pages=64, kv_demote_after_s=0.05,
                kv_remote_after_s=0.05, remote_kv_root=str(tmp_path))
    ja = jserver.ModelServer("jax-a", jengine.LLMEngine(
        jcfg, JBatchingSpec(**SPEC, **tier), params=jparams), port=0)
    jref = jserver.ModelServer("jax-ref", jengine.LLMEngine(
        jcfg, JBatchingSpec(**SPEC, enable_prefix_caching=False),
        params=jparams), port=0)
    ja.start()
    jref.start()
    b = None
    try:
        st, text1 = completion_text(ja.url, TURN1)
        assert st == 200
        assert completion_text(jref.url, TURN1) == (200, text1)
        wait_spilled(ja.engine, 3)
        jfaults.kill_model_server(ja)
        b = mk_server("port-b", spec(remote_root=tmp_path),
                      params=params_from_jax(
                          jax.tree.map(np.asarray, jparams), device="cpu"))
        turn2 = TURN1 + text1 + " and then"
        st, text2 = completion_text(b.url, turn2)
        assert st == 200
        assert completion_text(jref.url, turn2) == (200, text2)
        assert_store_hit(b.engine)
        audit_quiescent(b)
    finally:
        for s in (ja, jref) + ((b,) if b is not None else ()):
            try:
                s.stop()
            except OSError:
                pass
