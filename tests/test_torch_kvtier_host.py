"""The port's host-RAM KV tier (``kubeflow_tpu_torch/serve/kvtier.py``) on
the CPU, the host-tier cases of ``tests/test_serve_kvtier.py``:

- the index against a real ``PageAllocator`` with fake device closures:
  demote then promote carries the exact page bytes, host capacity evicts
  least recently used, and the same scenario through the JAX index gives
  the same stats; the page wire blobs round-trip (float, int8 + scales);
- the engine: an idle conversation demotes and then promotes on its next
  turn, with greedy tokens identical to an engine without the tier (and
  to the JAX engine's), float and int8 pools, the pool's page bytes equal
  before demotion and after promotion, no page referenced at the end; the
  tier's gauges and counters on ``/metrics``.

On the CPU the pinned buffer and copy event of a demotion reduce to a
plain copy; the migration thread, not the scheduler, still reads and
encodes the pages, which the tests check."""

import threading
import time

import numpy as np
import pytest
import torch

from kubeflow_tpu_torch.core.serving import BatchingSpec
from kubeflow_tpu_torch.models import config as tconfig
from kubeflow_tpu_torch.serve import kvtier as tkvtier
from kubeflow_tpu_torch.serve.engine import LLMEngine, SamplingParams
from kubeflow_tpu_torch.serve.handoff import pages_from_wire, pages_to_wire
from kubeflow_tpu_torch.serve.kvtier import RadixPrefixIndex
from kubeflow_tpu_torch.serve.paged import PageAllocator
from port_threads import torch_on_one_thread  # noqa: F401

PG = 4


class FakeDevice:
    """Records the device traffic the index would have enqueued."""

    def __init__(self, layers=2, kv=1, dh=2):
        self.shape = (layers, PG, kv, dh)
        self.copies: list = []
        self.uploads: list = []
        self.fetches: list = []

    def page_block(self, page: int) -> np.ndarray:
        return np.full(self.shape, float(page), np.float32)

    def copy_pages(self, src, dst):
        self.copies.append((list(src), list(dst)))

    def upload_pages(self, ids, k, v):
        self.uploads.append((list(ids), k, v))

    def fetch_pages(self, ids):
        self.fetches.append(list(ids))
        k = torch.from_numpy(
            np.stack([self.page_block(p) for p in ids], axis=1))
        return (k, k.clone()), None


def mk_index(num_pages=16, **kw):
    alloc = PageAllocator(num_pages, PG, enable_prefix_caching=True)
    dev = FakeDevice()
    idx = RadixPrefixIndex(
        alloc, PG, copy_pages_fn=dev.copy_pages,
        upload_pages_fn=dev.upload_pages, fetch_pages_fn=dev.fetch_pages,
        **kw)
    return idx, alloc, dev


def test_demote_then_promote_roundtrip():
    idx, alloc, dev = mk_index(host_pages=8, demote_after_s=0.01,
                               scan_interval_s=0.0)
    try:
        toks = list(range(1, 13))
        pages = alloc.alloc(3, owner="a")
        idx.insert(toks, pages, 12)
        alloc.free(list(reversed(pages)))
        time.sleep(0.05)
        assert idx.tick(now=time.monotonic()) == 3
        idx.drain_migrations()
        assert idx.host_pages_resident() == 3
        assert alloc.cached() == 0         # device pages freed
        assert sorted(dev.fetches[0]) == sorted(pages)
        hit, covered = idx.match_and_acquire(toks + [99], owner="b")
        assert covered == 12 and len(hit) == 3
        assert idx.host_pages_resident() == 0
        assert idx.stats["pages_promoted"] == 3
        ids, k, v = dev.uploads[-1]
        assert ids == hit
        # Per-page blocks in path order, bit-exact through the wire.
        for j, page in enumerate(pages):
            np.testing.assert_array_equal(k[j], dev.page_block(page))
        alloc.free(hit)
        alloc.assert_quiescent()
    finally:
        idx.close()


def test_host_capacity_evicts_lru():
    idx, alloc, _ = mk_index(host_pages=2, demote_after_s=0.0,
                             scan_interval_s=0.0)
    try:
        a = alloc.alloc(2, owner="a")
        idx.insert([1, 2, 3, 4, 5, 6, 7, 8], a, 8)
        alloc.free(list(reversed(a)))
        assert idx.tick(now=time.monotonic() + 1) == 2
        idx.drain_migrations()
        assert idx.host_pages_resident() == 2
        b = alloc.alloc(2, owner="b")
        idx.insert([9, 10, 11, 12, 13, 14, 15, 16], b, 8)
        alloc.free(list(reversed(b)))
        assert idx.tick(now=time.monotonic() + 10) == 2
        idx.drain_migrations()
        assert idx.host_pages_resident() == 2
        assert idx.stats["host_evictions"] >= 1
        # The older conversation is gone, the newer one promotes.
        assert idx.match_and_acquire([1, 2, 3, 4, 5, 6, 7, 8, 0])[1] == 0
        hit, covered = idx.match_and_acquire(
            [9, 10, 11, 12, 13, 14, 15, 16, 0], owner="c")
        assert covered == 8
        alloc.free(hit)
        alloc.assert_quiescent()
    finally:
        idx.close()


def test_host_tier_scenario_matches_the_jax_index():
    """One demote / evict / promote scenario through both indexes (the
    JAX one with numpy closures): the same matches and the same stats."""
    pytest.importorskip("jax")
    from kubeflow_tpu.serve import kvtier as jkvtier
    from kubeflow_tpu.serve import paged as jpaged

    def scenario(Index, Alloc, fetch):
        alloc = Alloc(12, PG, enable_prefix_caching=True)
        dev = FakeDevice()
        idx = Index(alloc, PG, host_pages=3, demote_after_s=0.0,
                    scan_interval_s=0.0, copy_pages_fn=dev.copy_pages,
                    upload_pages_fn=dev.upload_pages, fetch_pages_fn=fetch)
        log = []
        try:
            for toks in ([1, 2, 3, 4, 5, 6, 7, 8, 9, 10],
                         [1, 2, 3, 4, 11, 12, 13, 14],
                         [20, 21, 22, 23, 24, 25, 26, 27, 28]):
                pages = alloc.alloc(-(-len(toks) // PG), owner="w")
                idx.insert(toks, pages, len(toks))
                alloc.free(list(reversed(pages)))
                log.append(idx.tick(now=time.monotonic() + 5))
                idx.drain_migrations()
                log.append(idx.host_pages_resident())
            for q in ([1, 2, 3, 4, 5, 6, 7, 8, 0], [20, 21, 22, 23, 24, 0],
                      [1, 2, 3, 4, 11, 12, 13, 14, 0]):
                hit, covered = idx.match_and_acquire(q, owner="r")
                log.append((len(hit), covered, idx.host_pages_resident()))
                alloc.free(hit)
            stats = {k: v for k, v in idx.stats.items()}
            alloc.assert_quiescent()
        finally:
            idx.close()
        return log, stats, [len(u[0]) for u in dev.uploads]

    def jfetch(ids):
        k = np.stack([FakeDevice().page_block(p) for p in ids], axis=1)
        return k, k.copy()

    def tfetch(ids):
        (k, v), ev = FakeDevice().fetch_pages(ids)
        return (k, v), ev

    want = scenario(jkvtier.RadixPrefixIndex, jpaged.PageAllocator, jfetch)
    got = scenario(RadixPrefixIndex, PageAllocator, tfetch)
    assert got[0] == want[0]
    assert got[2] == want[2]
    for k, v in got[1].items():
        assert want[1][k] == v, k


def test_wire_roundtrip():
    k = np.arange(24, dtype=np.float32).reshape(2, 3, 2, 2)
    v = k * 2
    k2, v2, sk, sv = pages_from_wire(pages_to_wire(k, v))
    np.testing.assert_array_equal(k, k2)
    np.testing.assert_array_equal(v, v2)
    assert sk is None and sv is None    # v1 blob: no scale segment


def test_wire_roundtrip_int8_scales():
    rng = np.random.default_rng(0)
    kf = rng.standard_normal((2, 3, 4, 8), np.float32)
    k = np.clip(np.round(kf * 40), -127, 127).astype(np.int8)
    v = (k[::-1]).copy()
    sk = rng.random((2, 3, 4), np.float32) + 0.1
    sv = sk * 2
    blob = pages_to_wire(k, v, kv_sk=sk, kv_sv=sv)
    k2, v2, sk2, sv2 = pages_from_wire(blob)
    assert k2.dtype == np.int8 and sk2.dtype == np.float32
    for a, b in ((k, k2), (v, v2), (sk, sk2), (sv, sv2)):
        np.testing.assert_array_equal(a, b)
    full = pages_to_wire(kf, kf * 2)
    # int8 payload + 4/Dh scales against f32 pages: 0.375 at Dh=8.
    assert len(blob) < len(full) * 0.55, (len(blob), len(full))


# -- the engine ---------------------------------------------------------------

CFG = tconfig.preset("tiny", vocab_size=512, dtype="float32")
PROMPT = [6, 2, 8, 1, 8, 2, 8, 4] * 4


def mk_engine(*, prefix=True, host_pages=0, demote_after_s=2.0,
              kv_dtype=None):
    return LLMEngine(CFG, BatchingSpec(
        max_batch_size=4, max_seq_len=128, paged=True, page_size=16,
        enable_prefix_caching=prefix, host_kv_pages=host_pages,
        kv_demote_after_s=demote_after_s, kv_cache_dtype=kv_dtype,
        chunked_prefill_tokens=32, max_concurrent_prefills=2),
        seed=0, device="cpu")


def run_all(eng, reqs, max_steps=800):
    for _ in range(max_steps):
        eng.step()
        if all(r.done.is_set() for r in reqs):
            return
    raise AssertionError("requests did not finish")


def quiesce(eng, deadline_s=10.0):
    deadline = time.monotonic() + deadline_s
    while eng.kv_pages_in_use() > 0:
        eng.step()
        assert time.monotonic() < deadline, "KV pages leaked"
    eng._allocator.assert_quiescent()


def _planes(eng, pages):
    names = ("k", "v", "ks", "vs") if eng.kv_quant else ("k", "v")
    return {n: eng.cache[n][:, pages].clone() for n in names}


@pytest.mark.parametrize("kv_dtype", [None, "int8"], ids=["float", "int8"])
def test_idle_conversation_demotes_then_promotes(kv_dtype, monkeypatch):
    """Turn 1, an idle gap past the demote time, then the same prompt: the
    radix hit promotes BEFORE prefill admits, the promoted pages hold the
    bytes the demoted ones held, and the tokens equal an engine without
    the tier. The migration thread encodes every demoted page."""
    encoders = []
    real = tkvtier.pages_to_wire

    def spy(*a, **kw):
        encoders.append(threading.current_thread().name)
        return real(*a, **kw)

    monkeypatch.setattr(tkvtier, "pages_to_wire", spy)
    eng = mk_engine(host_pages=32, demote_after_s=0.05, kv_dtype=kv_dtype)
    base = mk_engine(prefix=False, kv_dtype=kv_dtype)
    try:
        sp = SamplingParams(max_new_tokens=6, temperature=0.0)
        r1 = eng.submit(list(PROMPT), sp)
        run_all(eng, [r1])
        cached = [p for p in eng._allocator.reclaimable_lru()]
        before = _planes(eng, cached)
        nodes = {p: eng._kvtier._by_page[p] for p in cached}
        deadline = time.monotonic() + 10.0
        while eng.kv_pages_host() < len(cached):
            eng.step()
            eng._kvtier.drain_migrations()
            time.sleep(0.01)
            assert time.monotonic() < deadline, "no demotion happened"
        assert eng.kv_pages_cached() == 0
        assert encoders and set(encoders) == {"kv-migrate"}
        r2 = eng.submit(list(PROMPT), sp)
        run_all(eng, [r2])
        b = base.submit(list(PROMPT), sp)
        run_all(base, [b])
        assert r1.output_tokens == b.output_tokens
        assert r2.output_tokens == b.output_tokens
        tier = eng.kv_tier_stats()
        assert tier["pages_demoted"] == len(cached)
        assert tier["pages_promoted"] > 0
        assert tier["demote_wire_bytes"] > 0
        assert tier["promote_wire_bytes"] > 0
        # Every promoted node's page holds the bytes its page held before
        # demotion (promotion allocates fresh page ids).
        after = {old: n.page for old, n in nodes.items()
                 if n.tier == tkvtier.TIER_DEVICE}
        assert after, "no page came back"
        now = _planes(eng, list(after.values()))
        for n, t in before.items():
            idx = [cached.index(old) for old in after]
            assert torch.equal(now[n], t[:, idx]), n
        quiesce(eng)
        quiesce(base)
    finally:
        eng.stop()
        base.stop()


def test_tokens_after_promotion_equal_the_jax_engine():
    """The tiered port engine's second turn against the JAX engine
    without a prefix cache, on the same weights."""
    jax = pytest.importorskip("jax")
    from kubeflow_tpu.core.serving import BatchingSpec as JBatchingSpec
    from kubeflow_tpu.models import config as jconfig
    from kubeflow_tpu.models import decoder as jdec
    from kubeflow_tpu.serve import engine as jengine
    from kubeflow_tpu_torch.models.convert import params_from_jax

    jcfg = jconfig.preset("tiny", vocab_size=512, dtype="float32")
    jparams = jdec.init_decoder_params(jax.random.PRNGKey(0), jcfg)
    spec = dict(max_batch_size=4, max_seq_len=128, paged=True, page_size=16,
                chunked_prefill_tokens=32)
    jeng = jengine.LLMEngine(jcfg, JBatchingSpec(
        **spec, enable_prefix_caching=False), params=jparams)
    want = jeng.generate(list(PROMPT), jengine.SamplingParams(
        max_new_tokens=6))
    eng = LLMEngine(CFG, BatchingSpec(**spec, host_kv_pages=16,
                                      kv_demote_after_s=0.05),
                    params=params_from_jax(jax.tree.map(np.asarray, jparams),
                                           device="cpu"), device="cpu")
    try:
        sp = SamplingParams(max_new_tokens=6)
        assert eng.generate(list(PROMPT), sp) == want
        deadline = time.monotonic() + 10.0
        while eng.kv_pages_host() == 0:
            eng.step()
            time.sleep(0.01)
            assert time.monotonic() < deadline, "no demotion happened"
        eng._kvtier.drain_migrations()
        assert eng.generate(list(PROMPT), sp) == want
        assert eng.kv_tier_stats()["pages_promoted"] > 0
        quiesce(eng)
    finally:
        eng.stop()


def test_tier_gauges_split_resident_vs_cached_vs_host():
    from kubeflow_tpu_torch.obs.registry import parse_exposition
    from kubeflow_tpu_torch.serve.server import serving_metrics_registry

    eng = mk_engine(host_pages=16, demote_after_s=0.05)
    try:
        sp = SamplingParams(max_new_tokens=4, temperature=0.0)
        r = eng.submit([4] * 20, sp)
        run_all(eng, [r])
        assert eng.kv_pages_in_use() == 0      # released: not load
        assert eng.kv_pages_cached() > 0       # but still cached
        text = serving_metrics_registry([("m", eng)]).render()
        vals = {n: v for n, labels, v in parse_exposition(text)}
        assert vals["kftpu_engine_kv_pages_resident"] == 0
        assert vals["kftpu_engine_kv_pages_cached"] > 0
        assert vals["kftpu_engine_kv_pages_host"] == 0
        deadline = time.monotonic() + 10.0
        while eng.kv_pages_host() == 0:
            eng.step()
            time.sleep(0.01)
            assert time.monotonic() < deadline, "no demotion happened"
        eng._kvtier.drain_migrations()
        text = serving_metrics_registry([("m", eng)]).render()
        vals = {n: v for n, labels, v in parse_exposition(text)}
        assert vals["kftpu_engine_kv_pages_host"] == eng.kv_pages_host() > 0
        assert vals["kftpu_engine_kv_pages_demoted_total"] > 0
        assert vals["kftpu_engine_kv_wire_bytes_demoted_total"] > 0
    finally:
        eng.stop()


def test_host_tier_needs_the_radix_pool(tmp_path):
    with pytest.raises(ValueError, match="radix"):
        BatchingSpec(paged=True, host_kv_pages=4, prefix_index="flat")
    with pytest.raises(ValueError, match="paged"):
        LLMEngine(CFG, BatchingSpec(max_seq_len=128, host_kv_pages=4),
                  device="cpu")
    # The remote tier behind it is served, LoRA beside it too, and int8
    # weights beside both (the tier reads no weight).
    eng = LLMEngine(CFG, BatchingSpec(max_seq_len=128, paged=True,
                                      page_size=16, host_kv_pages=4,
                                      remote_kv_root=str(tmp_path / "kv"),
                                      lora={"max_adapters": 2},
                                      quantize="int8"),
                    device="cpu")
    assert eng.stop()
    with pytest.raises(ValueError, match="host_kv_pages"):
        BatchingSpec(paged=True, remote_kv_root="/nowhere")
