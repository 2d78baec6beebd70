"""The port's serve-side chaos suite on the CPU (the scenarios of
``tests/test_serve_chaos.py``): port model servers behind the port router,
faults injected mid-traffic through ``kubeflow_tpu_torch/serve/faults.py``,
every engine under ``KFTPU_SANITIZE=refcount``.

Invariants asserted after every scenario:
- no hangs: every client thread joins within its bound;
- every request completes (200) or fails with an explicit HTTP status —
  never a silent stall;
- the router recovers: fresh requests succeed afterwards;
- paged-KV refcounts balance: once quiescent, every engine holds zero
  pages, and the per-owner report names no leak.

The shared stack's kill scenario runs last: it destroys one replica."""

import os
import threading
import time

import pytest

from fleet_support import (
    EXPLICIT_STATUSES, audit_quiescent, completion, fire, stop_all,
)
from kubeflow_tpu_torch.core.serving import BatchingSpec, QoSClassPolicy
from kubeflow_tpu_torch.models.config import preset
from kubeflow_tpu_torch.serve import kvtier
from kubeflow_tpu_torch.serve.engine import LLMEngine, SamplingParams
from kubeflow_tpu_torch.serve.faults import ChaosProxy, kill_model_server
from kubeflow_tpu_torch.serve.router import Router
from kubeflow_tpu_torch.serve.server import ModelServer

CFG = preset("tiny", vocab_size=512, dtype="float32")   # byte tokenizer fits
SPEC = dict(max_batch_size=2, max_seq_len=96, prefill_buckets=[32],
            paged=True, page_size=16, chunked_prefill_tokens=16,
            decode_steps=4)


def mk_server(name, **kw):
    srv = ModelServer(name, LLMEngine(CFG, BatchingSpec(**SPEC, **kw),
                                      seed=0, device="cpu"))
    srv.start()
    return srv


def mk_router(**kw):
    kw = dict(dict(queue_timeout=5.0, eject_threshold=2, eject_period=0.4,
                   max_retries=2, upstream_timeout=30.0), **kw)
    r = Router(**kw)
    return r


def assert_no_owner_leaks(*servers):
    for srv in servers:
        alloc = srv.engine._allocator
        assert alloc.refcount_debug
        assert alloc.stats["stamped_allocs"] > 0, \
            f"{srv.name}: no stamped page traffic recorded"
        assert alloc.leak_report_by_owner() == {}, srv.name
        alloc.assert_quiescent()


@pytest.fixture(scope="module")
def stack():
    prev = os.environ.get("KFTPU_SANITIZE")
    os.environ["KFTPU_SANITIZE"] = "refcount"
    try:
        # Every scenario runs with a decode round possibly in flight.
        a = mk_server("replica-a", pipelined_decode=True)
        b = mk_server("replica-b", pipelined_decode=True)
    finally:
        if prev is None:
            os.environ.pop("KFTPU_SANITIZE")
        else:
            os.environ["KFTPU_SANITIZE"] = prev
    router = mk_router()
    router.set_backends({"latest": [a.url, b.url]})
    router.start()
    yield a, b, router
    router.stop()
    stop_all(a, b)


def test_chaos_5xx_burst_ejects_then_recovers(stack):
    a, b, router = stack
    proxy = ChaosProxy(a.url)
    proxy.start()
    try:
        router.set_backends({"latest": [proxy.url, b.url]})
        proxy.fail_next(4, code=503)
        results = fire(router.url, 12, timeout_s=10.0)
        assert set(results) <= EXPLICIT_STATUSES
        assert results.count(200) >= 6, results
        assert router.snapshot()["ejections"] >= 1
        assert proxy.stats["injected_5xx"] >= 2     # the burst landed
        # End the burst, let the window pass: clean traffic, the half-open
        # probe that reinstates the backend included.
        proxy.fail_next(0)
        time.sleep(0.5)
        assert all(s == 200 for s in fire(router.url, 4, timeout_s=10.0))
    finally:
        proxy.stop()
        router.set_backends({"latest": [a.url, b.url]})
    audit_quiescent(a, b)
    assert_no_owner_leaks(a, b)


def test_chaos_wedged_replica_fails_within_deadline(stack):
    a, b, router = stack
    proxy = ChaosProxy(a.url)
    proxy.start()
    try:
        router.set_backends({"latest": [proxy.url, b.url]})
        proxy.wedge()
        t0 = time.monotonic()
        results = fire(router.url, 8, timeout_s=3.0)
        elapsed = time.monotonic() - t0
        assert set(results) <= EXPLICIT_STATUSES
        # The healthy replica keeps serving; picks of the wedged one end
        # at their deadline.
        assert results.count(200) >= 4, results
        assert elapsed < 60.0
        proxy.unwedge()
        time.sleep(0.5)
        assert all(s == 200 for s in fire(router.url, 4, timeout_s=10.0))
    finally:
        proxy.stop()
        router.set_backends({"latest": [a.url, b.url]})
    audit_quiescent(a, b)
    assert_no_owner_leaks(a, b)


def test_chaos_scale_down_under_load_drains_cleanly(stack):
    """Replica a leaves the rotation while its request still streams: the
    request completes, new traffic goes to b, a drains to zero pages."""
    a, b, router = stack
    router.set_backends({"latest": [a.url]})
    got: dict = {}

    def long_request():
        got["status"] = completion(router.url, timeout_s=15.0, max_tokens=48)

    t = threading.Thread(target=long_request)
    t.start()
    deadline = time.monotonic() + 10.0
    while a.in_flight == 0 and not got:
        assert time.monotonic() < deadline
        time.sleep(0.005)
    router.set_backends({"latest": [b.url]})     # a retired mid-request
    t.join(timeout=30.0)
    assert not t.is_alive(), "in-flight request hung through scale-down"
    assert got["status"] == 200, "draining replica dropped its request"
    assert all(s == 200 for s in fire(router.url, 4, timeout_s=10.0))
    router.set_backends({"latest": [a.url, b.url]})
    audit_quiescent(a, b)
    assert_no_owner_leaks(a, b)


def test_chaos_halt_with_round_in_flight_reaps_clean(monkeypatch):
    """The scheduler halting between dispatch and consume of a pipelined
    decode round: recovery cancels, drives step() like a supervisor, and
    the stranded round drains without its tokens reaching the cancelled
    streams; every refcount returns to zero."""
    monkeypatch.setenv("KFTPU_SANITIZE", "refcount")
    eng = LLMEngine(CFG, BatchingSpec(**SPEC, pipelined_decode=True),
                    seed=0, device="cpu")
    reqs = [eng.submit([i + 1] * 20, SamplingParams(max_new_tokens=60))
            for i in range(2)]
    for _ in range(3):
        eng.step()
    assert eng._rounds, "pipelining should have a round in flight here"
    emitted_at_halt = [len(r.output_tokens) for r in reqs]
    for r in reqs:
        r.cancel()
    deadline = time.monotonic() + 20.0
    while eng.kv_pages_in_use() > 0 or eng._rounds:
        eng.step()
        assert time.monotonic() < deadline, "recovery did not quiesce"
    eng._allocator.assert_quiescent()
    assert eng._allocator.leak_report_by_owner() == {}
    assert all(r.done.is_set() and r.finish_reason == "cancelled"
               for r in reqs)
    assert [len(r.output_tokens) for r in reqs] == emitted_at_halt


def test_chaos_qos_overload_sheds_batch_first(stack):
    """~2x sustained overload with interactive and batch classes through
    the router: batch absorbs all shedding, interactive is never shed and
    its queue-delay p95 stays within its budget; afterwards every engine
    drains to zero pages."""
    a, b, router = stack
    i_budget_s = 5.0
    engines = [a.engine, b.engine]
    for eng in engines:
        eng.max_queue = 4
        eng.qos_policies = {
            "batch": QoSClassPolicy(max_queue=1),
            "interactive": QoSClassPolicy(queue_delay_budget=i_budget_s)}
    try:
        results: dict[str, list[int]] = {"interactive": [], "batch": []}
        threads = []
        for cls in ("interactive", "batch"):
            def pool(cls=cls):
                results[cls].extend(fire(router.url, 9, concurrency=3,
                                         timeout_s=10.0, max_tokens=6,
                                         qos=cls))
            t = threading.Thread(target=pool)
            threads.append(t)
            t.start()
        for t in threads:
            t.join(timeout=120.0)
            assert not t.is_alive(), "client pool hung under qos overload"
        for cls in results:
            assert set(results[cls]) <= EXPLICIT_STATUSES, results[cls]
        assert all(s == 200 for s in results["interactive"]), \
            results["interactive"]
        shed = {"interactive": 0, "batch": 0}
        qd_p95 = []
        for eng in engines:
            snap = eng.metrics.snapshot()
            for cls in shed:
                shed[cls] += snap.get("qos", {}).get(cls, {}).get("shed", 0)
            qcls = snap.get("qos", {}).get("interactive", {})
            if "queue_delay_p95_ms" in qcls:
                qd_p95.append(qcls["queue_delay_p95_ms"])
        assert shed["interactive"] == 0, "interactive was shed"
        if 429 in results["batch"]:
            assert shed["batch"] > 0
        assert qd_p95, "no interactive queue-delay signal recorded"
        assert max(qd_p95) <= i_budget_s * 1e3
    finally:
        for eng in engines:
            eng.max_queue = 0
            eng.qos_policies = {}
    audit_quiescent(a, b)
    assert_no_owner_leaks(a, b)


@pytest.mark.parametrize("kv_dtype", [None, "int8"], ids=["float", "int8"])
def test_chaos_kill_mid_migration(kv_dtype, monkeypatch):
    """Kill a replica while a device→host demotion batch is in flight on
    its migration thread: traffic keeps resolving on the survivor, both
    pools balance per owner (the demoted pages were freed scheduler-side
    before the kill), the host tier stays within budget with nothing left
    migrating, and the survivor's tokens equal a fresh engine's."""
    monkeypatch.setenv("KFTPU_SANITIZE", "refcount")
    real_wire = kvtier.pages_to_wire

    def slow_wire(k, v, **kw):
        time.sleep(0.25)                # widen the mid-migration window
        return real_wire(k, v, **kw)

    monkeypatch.setattr(kvtier, "pages_to_wire", slow_wire)
    tier = dict(kv_cache_dtype=kv_dtype, host_kv_pages=48,
                kv_demote_after_s=0.05)
    a, b = mk_server("mig-a", **tier), mk_server("mig-b", **tier)
    router = mk_router()
    router.set_backends({"latest": [b.url, a.url]})
    router.start()
    try:
        results = fire(router.url, 8, timeout_s=6.0)
        assert set(results) <= EXPLICIT_STATUSES
        deadline = time.monotonic() + 15.0
        while time.monotonic() < deadline:
            with b.engine._kvtier._lock:
                migrating = b.engine._kvtier._migrating
            if migrating > 0 or b.engine.kv_pages_host() > 0:
                break
            time.sleep(0.01)
        assert migrating > 0 or b.engine.kv_pages_host() > 0, \
            "no demotion ever started on b"
        kill_model_server(b)
        results = fire(router.url, 8, timeout_s=6.0)
        assert set(results) <= EXPLICIT_STATUSES
        assert results.count(200) >= 4, results
        audit_quiescent(a, b)
        sp = SamplingParams(max_new_tokens=8, temperature=0.0)
        prompt = [2, 7, 1, 8, 2, 8] * 4
        got = a.engine.generate(list(prompt), sp)
        want = LLMEngine(CFG, BatchingSpec(**SPEC, **tier), seed=0,
                         device="cpu").generate(list(prompt), sp)
        assert got == want, (got, want)
        audit_quiescent(a, b)
        assert_no_owner_leaks(a, b)
        for srv in (a, b):
            t = srv.engine._kvtier
            t.drain_migrations(timeout_s=10.0)
            snap = t.snapshot()
            assert 0 <= snap["host_pages_resident"] <= 48
            assert snap["migrating_pages"] == 0
    finally:
        router.stop()
        stop_all(a, b)


@pytest.mark.parametrize("kv_dtype", [None, "int8"], ids=["float", "int8"])
def test_chaos_prefill_kill_mid_handoff_unified_fallback(kv_dtype,
                                                         monkeypatch):
    """Kill the PREFILL replica of a disaggregated fleet mid-handoff (pages
    exported to an ack hold, the decode side never told): the stranded
    hold reaps refcount-balanced on both pools, and continuing traffic
    falls back to the decode replica serving whole requests — explicitly,
    with a fresh engine's tokens."""
    monkeypatch.setenv("KFTPU_SANITIZE", "refcount")
    pre = mk_server("pre-a", role="prefill", kv_cache_dtype=kv_dtype)
    dec = mk_server("dec-b", role="decode", kv_cache_dtype=kv_dtype)
    proxy = ChaosProxy(pre.url)      # the prefill replica's "process"
    proxy.start()
    router = mk_router(eject_period=5.0)
    router.scrape_interval = 0.1
    router.set_pools({"prefill": [proxy.url], "decode": [dec.url]})
    router.start()
    try:
        results = fire(router.url, 6, timeout_s=10.0)
        assert set(results) <= EXPLICIT_STATUSES
        assert results.count(200) >= 4, results
        assert pre.engine.metrics.snapshot()["handoffs_exported"] >= 1
        assert dec.engine.metrics.snapshot()["handoffs_adopted"] >= 1
        orphan = pre.engine.submit([7] * 24, SamplingParams(max_new_tokens=8),
                                   handoff=True)
        assert orphan.done.wait(20.0)
        assert orphan.finish_reason == "handoff"
        if kv_dtype:
            assert orphan.handoff.cache_dtype == "int8"
        assert pre.engine._handoff_holds, "no hold backing the payload"
        assert pre.engine.kv_pages_in_use() > 0
        proxy.drop()
        kill_model_server(pre)
        time.sleep(0.5)     # the scrape loop ejects the corpse
        results = fire(router.url, 8, timeout_s=10.0)
        assert set(results) <= EXPLICIT_STATUSES
        assert results.count(200) >= 4, results
        assert router.snapshot()["disagg_fallbacks"] >= 1
        sp = SamplingParams(max_new_tokens=8, temperature=0.0)
        prompt = [3, 1, 4, 1, 5, 9] * 4
        got = dec.engine.generate(list(prompt), sp)
        want = LLMEngine(CFG, BatchingSpec(**SPEC, kv_cache_dtype=kv_dtype),
                         seed=0, device="cpu").generate(list(prompt), sp)
        assert got == want, (got, want)
        audit_quiescent(pre, dec)
        assert_no_owner_leaks(pre, dec)
    finally:
        proxy.stop()
        router.stop()
        stop_all(pre, dec)


def test_chaos_cancel_while_shared(monkeypatch):
    """Cancel a request whose prefix pages are shared ref>0 with another
    in-flight request: the co-sharer finishes with the greedy output of an
    engine without sharing, and the per-owner report names no leak."""
    monkeypatch.setenv("KFTPU_SANITIZE", "refcount")
    spec = {k: v for k, v in SPEC.items() if k != "prefill_buckets"}

    def mk(prefix):
        return LLMEngine(CFG, BatchingSpec(**spec,
                                           enable_prefix_caching=prefix),
                         seed=0, device="cpu")

    eng, base = mk(True), mk(False)
    assert eng._allocator.refcount_debug
    sp = SamplingParams(max_new_tokens=24)
    prompt = [9, 2, 9, 4, 9, 6, 9, 8] * 4
    victim = eng.submit(list(prompt), sp)
    for _ in range(4):
        eng.step()                      # the victim prefills and registers
    sharer = eng.submit(list(prompt), sp)
    for _ in range(3):
        eng.step()                      # the sharer matches ref>0 pages
    assert eng.kv_tier_stats()["prefix_hits"] >= 1
    victim.cancel()                     # mid-decode, pages shared
    deadline = time.monotonic() + 30.0
    while not sharer.done.is_set():
        eng.step()
        assert time.monotonic() < deadline, "sharer hung after cancel"
    assert victim.finish_reason == "cancelled"
    b = base.submit(list(prompt), sp)
    while not b.done.is_set():
        base.step()
    assert list(sharer.output_tokens) == list(b.output_tokens)
    while eng.kv_pages_in_use() > 0:
        eng.step()
        assert time.monotonic() < deadline
    assert eng._allocator.leak_report_by_owner() == {}
    eng._allocator.assert_quiescent()


def test_chaos_refcount_sanitizer_kill_mid_traffic(monkeypatch):
    """A kill mid-traffic on a stack built under the sanitizer: the
    recovery audit gives a per-owner zero-leak report on both replicas —
    every page reference was stamped with its request and popped."""
    monkeypatch.setenv("KFTPU_SANITIZE", "refcount")
    a, b = mk_server("rc-a"), mk_server("rc-b")
    router = mk_router()
    router.set_backends({"latest": [a.url, b.url]})
    router.start()
    try:
        results = fire(router.url, 12, timeout_s=6.0,
                       mid_fault=lambda: kill_model_server(b), fault_after=2)
        assert set(results) <= EXPLICIT_STATUSES
        assert results.count(200) >= 4, results
        audit_quiescent(a, b)
        assert_no_owner_leaks(a, b)
    finally:
        router.stop()
        stop_all(a, b)


def test_chaos_zz_replica_kill_mid_traffic(stack):
    """A kill mid-traffic on the shared stack (last: b never comes back):
    requests racing the kill resolve explicitly, the router ejects the
    corpse and recovers on the survivor, and the dead engine's stranded
    state reaps to zero leaks."""
    a, b, router = stack
    results = fire(router.url, 12, timeout_s=6.0,
                   mid_fault=lambda: kill_model_server(b), fault_after=2)
    assert set(results) <= EXPLICIT_STATUSES
    assert results.count(200) >= 4, results
    assert all(s == 200 for s in fire(router.url, 4, timeout_s=10.0))
    snap = router.snapshot()
    assert snap["connect_failures"] >= 1 or snap["http_5xx"] >= 1
    audit_quiescent(a, b)
    assert_no_owner_leaks(a, b)
