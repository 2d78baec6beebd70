"""The port's remote KV tier (``kubeflow_tpu_torch/serve/kvtier.py``'s third
tier over ``pipelines/artifacts.py``) on the CPU:

- every case of ``tests/test_serve_kvtier.py::TestRemoteTier`` on the
  port's index with the port's fake device (spill then promote, failover
  to a fresh index through the registry, a fabric-signature mismatch, a
  truncated blob, a wedged store, a failed publish, the forced drain, and
  the JAX package's GC sweep over a root the port wrote);
- the registry keys against the JAX index's, string for string;
- across packages: a JAX index spills into a root and a port index adopts
  it with the JAX page's bytes, and the reverse;
- the engine: a conversation spilled by one port engine and adopted by
  another on the same root gives the tier-free engine's tokens and the
  JAX engine's, its counters show the store hit, the fabric signature is
  the JAX engine's, and a blob of another float dtype is cast on upload.

Every store hit asserts its counters (``remote_registry_hits``,
``pages_promoted_remote``, ``prefix_hits``): a lookup under a wrong key is
an ordinary miss, and a miss recomputes to the same greedy tokens."""

import time

import numpy as np
import pytest
import torch

from kubeflow_tpu_torch.core.serving import BatchingSpec
from kubeflow_tpu_torch.models import config as tconfig
from kubeflow_tpu_torch.pipelines.artifacts import ArtifactStore
from kubeflow_tpu_torch.serve.engine import LLMEngine, SamplingParams
from kubeflow_tpu_torch.serve.faults import ChaosStore
from kubeflow_tpu_torch.serve.kvtier import RadixPrefixIndex
from kubeflow_tpu_torch.serve.paged import PageAllocator

PG = 4
SIG = "L2.H1.D2.P4.full"
TOKS = list(range(1, 13))


class FakeDevice:
    """Records the device traffic the index would have enqueued (the port's
    closures: the fetch returns host tensors and a ready event)."""

    def __init__(self, layers=2, kv=1, dh=2):
        self.shape = (layers, PG, kv, dh)
        self.copies: list = []
        self.uploads: list = []

    def page_block(self, page: int) -> np.ndarray:
        return np.full(self.shape, float(page), np.float32)

    def copy_pages(self, src, dst):
        self.copies.append((list(src), list(dst)))

    def upload_pages(self, ids, k, v):
        self.uploads.append((list(ids), k, v))

    def fetch_pages(self, ids):
        k = torch.from_numpy(
            np.stack([self.page_block(p) for p in ids], axis=1))
        return (k, k.clone()), None


class JaxFakeDevice(FakeDevice):
    """The JAX index's closures: the fetch returns numpy planes."""

    def fetch_pages(self, ids):
        k = np.stack([self.page_block(p) for p in ids], axis=1)
        return k, k.copy()


def mk_index(store, Index=RadixPrefixIndex, Alloc=PageAllocator,
             dev=None, num_pages=16, **kw):
    kw.setdefault("host_pages", 8)
    kw.setdefault("demote_after_s", 0.01)
    kw.setdefault("scan_interval_s", 0.0)
    kw.setdefault("remote_after_s", 0.0)
    kw.setdefault("fabric_sig", SIG)
    alloc = Alloc(num_pages, PG, enable_prefix_caching=True)
    dev = dev or FakeDevice()
    idx = Index(alloc, PG, copy_pages_fn=dev.copy_pages,
                upload_pages_fn=dev.upload_pages,
                fetch_pages_fn=dev.fetch_pages, remote_store=store, **kw)
    return idx, alloc, dev


def spill(idx, alloc, toks=TOKS):
    """Insert → release → demote to the host → spill to the store."""
    pages = alloc.alloc(len(toks) // PG, owner="a")
    idx.insert(toks, pages, len(toks))
    alloc.free(list(reversed(pages)))
    idx.tick(now=time.monotonic() + 1)       # device -> host
    idx.drain_migrations()
    idx.tick(now=time.monotonic() + 10)      # host -> remote
    idx.drain_migrations()
    return pages


def spilled_root(store, toks=TOKS):
    """A store holding ``toks``' three pages, spilled by a closed index;
    returns the pages it held (their fake bytes are the page ids)."""
    idx, alloc, _ = mk_index(store)
    try:
        return spill(idx, alloc, toks)
    finally:
        idx.close()


def assert_store_hit(idx, pages=3):
    snap = idx.snapshot()
    assert snap["remote_registry_hits"] >= pages, snap
    assert snap["pages_promoted_remote"] == pages, snap
    assert snap["prefix_hits"] >= 1, snap


# -- TestRemoteTier's cases ----------------------------------------------------

def test_spill_then_promote_roundtrip(tmp_path):
    idx, alloc, dev = mk_index(ArtifactStore(str(tmp_path)))
    try:
        pages = spill(idx, alloc)
        assert idx.remote_pages_resident() == 3
        assert idx.host_pages_resident() == 0
        snap = idx.snapshot()
        assert snap["pages_demoted_remote"] == 3
        assert snap["remote_demote_bytes"] > 0
        hit, covered = idx.match_and_acquire(TOKS + [99], owner="b")
        assert covered == 12 and len(hit) == 3
        assert idx.remote_pages_resident() == 0
        snap = idx.snapshot()
        assert snap["pages_promoted_remote"] == 3
        assert snap["remote_promote_bytes"] > 0
        ids, k, v = dev.uploads[-1]
        assert ids == hit
        for j, page in enumerate(pages):
            np.testing.assert_array_equal(k[j], dev.page_block(page))
        alloc.free(hit)
        alloc.assert_quiescent()
    finally:
        idx.close()


def test_cross_index_failover_via_registry(tmp_path):
    """A fresh index (same store, same fabric signature) adopts the spilled
    subtree through the registry: the next turn after a kill lands on a
    survivor and reuses the stored prefix."""
    store = ArtifactStore(str(tmp_path))
    pages_a = spilled_root(store)
    idx_b, alloc_b, dev_b = mk_index(store)
    try:
        hit, covered = idx_b.match_and_acquire(TOKS + [99], owner="b")
        assert covered == 12 and len(hit) == 3
        assert_store_hit(idx_b)
        ids, k, v = dev_b.uploads[-1]
        for j, page in enumerate(pages_a):
            np.testing.assert_array_equal(k[j], dev_b.page_block(page))
        alloc_b.free(hit)
        alloc_b.assert_quiescent()
    finally:
        idx_b.close()


def test_fabric_sig_mismatch_never_adopts(tmp_path):
    store = ArtifactStore(str(tmp_path))
    spilled_root(store)
    idx_b, alloc_b, _ = mk_index(store, fabric_sig="L2.H1.D2.P4.int8")
    try:
        hit, covered = idx_b.match_and_acquire(TOKS + [99], owner="b")
        assert covered == 0 and hit == []
        assert idx_b.snapshot()["remote_registry_hits"] == 0
        alloc_b.assert_quiescent()
    finally:
        idx_b.close()


def test_truncated_blob_rejected_by_checksum(tmp_path):
    chaos = ChaosStore(ArtifactStore(str(tmp_path)))
    spilled_root(chaos)
    idx_b, alloc_b, _ = mk_index(chaos)
    try:
        chaos.truncate_next(8)
        hit, covered = idx_b.match_and_acquire(TOKS + [99], owner="b")
        assert covered == 0 and hit == []
        assert idx_b.snapshot()["remote_blobs_corrupt"] >= 1
        assert chaos.stats["truncated_reads"] >= 1
        alloc_b.assert_quiescent()
    finally:
        chaos.truncate_next(0)
        idx_b.close()


def test_wedged_store_degrades_within_deadline(tmp_path):
    chaos = ChaosStore(ArtifactStore(str(tmp_path)))
    spilled_root(chaos)
    idx_b, alloc_b, _ = mk_index(chaos, remote_deadline_s=0.15)
    try:
        chaos.wedge_promote()
        t0 = time.monotonic()
        hit, covered = idx_b.match_and_acquire(TOKS + [99], owner="b")
        elapsed = time.monotonic() - t0
        assert covered == 0 and hit == []
        assert elapsed < 2.0, f"match wedged for {elapsed:.2f}s"
        assert idx_b.snapshot()["remote_promote_timeouts"] >= 1
        assert chaos.stats["wedged_reads"] >= 1
        alloc_b.assert_quiescent()
    finally:
        chaos.unwedge()
        idx_b.close()


def test_spill_publish_failure_reverts_to_host(tmp_path):
    chaos = ChaosStore(ArtifactStore(str(tmp_path)))
    # Long remote_after_s: only the explicit future-now tick spills.
    idx, alloc, _ = mk_index(chaos, remote_after_s=60.0)
    try:
        pages = alloc.alloc(3, owner="a")
        idx.insert(TOKS, pages, 12)
        alloc.free(list(reversed(pages)))
        idx.tick(now=time.monotonic() + 1)
        idx.drain_migrations()               # hosted
        chaos.fail_next(100)                 # the store goes dark
        idx.tick(now=time.monotonic() + 120)
        idx.drain_migrations()
        chaos.fail_next(0)
        assert idx.remote_pages_resident() == 0
        assert idx.host_pages_resident() == 3
        assert idx.snapshot()["remote_spill_errors"] >= 1
        hit, covered = idx.match_and_acquire(TOKS + [99], owner="b")
        assert covered == 12
        assert idx.snapshot()["pages_promoted"] == 3
        alloc.free(hit)
        alloc.assert_quiescent()
    finally:
        idx.close()


def test_spill_all_to_remote_forced(tmp_path):
    idx, alloc, _ = mk_index(ArtifactStore(str(tmp_path)),
                             demote_after_s=60.0, remote_after_s=60.0)
    try:
        pages = alloc.alloc(3, owner="a")
        idx.insert(TOKS, pages, 12)
        alloc.free(list(reversed(pages)))
        assert idx.spill_all_to_remote() == 3
        assert idx.remote_pages_resident() == 3
        assert alloc.cached() == 0
        hit, covered = idx.match_and_acquire(TOKS + [99], owner="b")
        assert covered == 12
        alloc.free(hit)
        alloc.assert_quiescent()
    finally:
        idx.close()


def test_gc_sweeps_orphans_keeps_registered(tmp_path):
    """The JAX package's GC sweep over a root the port wrote: an orphan
    (published, never registered — the publish → register crash window)
    goes, the registered spill blobs stay promotable."""
    import os

    pytest.importorskip("jax")
    from kubeflow_tpu.pipelines.artifacts import ArtifactStore as JStore
    from kubeflow_tpu.pipelines.gc import collect_garbage

    store = ArtifactStore(str(tmp_path))
    spilled_root(store)
    orphan = store.put_bytes(b"kv blob from an engine killed mid-demote")
    past = time.time() - 3600
    os.utime(store.path_for(orphan), (past, past))
    report = collect_garbage(JStore(str(tmp_path)), None, min_age_s=600.0)
    assert report["swept_blobs"] == 1
    assert not store.exists(orphan)
    idx_b, alloc_b, _ = mk_index(store)
    try:
        hit, covered = idx_b.match_and_acquire(TOKS + [99], owner="b")
        assert covered == 12
        assert_store_hit(idx_b)
        alloc_b.free(hit)
        alloc_b.assert_quiescent()
    finally:
        idx_b.close()


# -- against the JAX index -----------------------------------------------------

CHAINS = [
    ("L2.H1.D2.P4.full", ((1, 2, 3, 4),)),
    ("L2.H1.D2.P4.full", ((1, 2, 3, 4), (5, 6, 7, 8), (9, 10, 11, 12))),
    ("L32.H8.D128.P128.int8", (tuple(range(128)), tuple(range(7, 135)))),
    ("", ((0, 0, 0, 0),)),
]


@pytest.mark.parametrize("sig,chain", CHAINS,
                         ids=["one", "three", "llama-int8", "no-sig"])
def test_remote_key_equals_the_jax_index(sig, chain, tmp_path):
    pytest.importorskip("jax")
    from kubeflow_tpu.serve import kvtier as jkvtier
    from kubeflow_tpu.serve import paged as jpaged

    jidx, _, _ = mk_index(None, Index=jkvtier.RadixPrefixIndex,
                          Alloc=jpaged.PageAllocator, dev=JaxFakeDevice(),
                          fabric_sig=sig)
    tidx, _, _ = mk_index(None, fabric_sig=sig)
    try:
        want = jidx._remote_key("", chain)
        assert tidx._remote_key("", chain) == want
        # Tokens that arrive as numpy or torch scalars hash as Python ints.
        as_np = tuple(tuple(np.int64(t) for t in b) for b in chain)
        as_torch = tuple(tuple(torch.tensor(b).unbind()) for b in chain)
        assert tidx._remote_key("", as_np) == want
        assert tidx._remote_key("", as_torch) == want
    finally:
        jidx.close()
        tidx.close()


def test_jax_spill_port_adopts_and_port_spill_jax_adopts(tmp_path):
    """Across packages on one root: the JAX index spills and a port index
    adopts the JAX page's bytes; then a port index spills another
    conversation and a JAX index adopts the port page's bytes."""
    pytest.importorskip("jax")
    from kubeflow_tpu.pipelines.artifacts import ArtifactStore as JStore
    from kubeflow_tpu.serve import kvtier as jkvtier
    from kubeflow_tpu.serve import paged as jpaged

    def jax_index(**kw):
        return mk_index(JStore(str(tmp_path)), Index=jkvtier.RadixPrefixIndex,
                        Alloc=jpaged.PageAllocator, dev=JaxFakeDevice(), **kw)

    jidx, jalloc, jdev = jax_index()
    try:
        jpages = spill(jidx, jalloc)
        assert jidx.remote_pages_resident() == 3
    finally:
        jidx.close()
    tidx, talloc, tdev = mk_index(ArtifactStore(str(tmp_path)))
    try:
        hit, covered = tidx.match_and_acquire(TOKS + [99], owner="b")
        assert covered == 12
        assert_store_hit(tidx)
        _, k, v = tdev.uploads[-1]
        for j, page in enumerate(jpages):
            np.testing.assert_array_equal(k[j], jdev.page_block(page))
            np.testing.assert_array_equal(v[j], jdev.page_block(page))
        talloc.free(hit)
        talloc.assert_quiescent()
    finally:
        tidx.close()

    other = list(range(40, 52))
    tidx, talloc, tdev = mk_index(ArtifactStore(str(tmp_path)),
                                  num_pages=32)
    try:
        talloc.alloc(9, owner="pad")         # other page ids than the JAX run
        tpages = spill(tidx, talloc, other)
        assert tidx.remote_pages_resident() == 3
    finally:
        tidx.close()
    jidx, jalloc, jdev = jax_index()
    try:
        hit, covered = jidx.match_and_acquire(other + [99], owner="b")
        assert covered == 12
        assert_store_hit(jidx)
        _, k, v = jdev.uploads[-1]
        for j, page in enumerate(tpages):
            np.testing.assert_array_equal(k[j], tdev.page_block(page))
        jalloc.free(hit)
        jalloc.assert_quiescent()
    finally:
        jidx.close()


# -- the engine ----------------------------------------------------------------

CFG = tconfig.preset("tiny", vocab_size=512, dtype="float32")
TURN1 = [(7 * i + 3) % 97 + 1 for i in range(40)]   # 2 full pages + 8


def spec(root=None, **kw):
    if root is not None:
        kw.update(host_kv_pages=32, kv_demote_after_s=0.05,
                  kv_remote_after_s=0.05, remote_kv_root=str(root))
    return BatchingSpec(max_batch_size=2, max_seq_len=96, paged=True,
                        page_size=16, chunked_prefill_tokens=16,
                        decode_steps=4, **kw)


def wait_spilled(eng, pages, deadline_s=20.0):
    deadline = time.monotonic() + deadline_s
    while eng.kv_tier_stats()["pages_demoted_remote"] < pages:
        eng.step()
        time.sleep(0.01)
        assert time.monotonic() < deadline, eng.kv_tier_stats()


def quiesce(eng, deadline_s=10.0):
    deadline = time.monotonic() + deadline_s
    while eng.kv_pages_in_use() > 0:
        eng.step()
        assert time.monotonic() < deadline, "KV pages leaked"
    eng._allocator.assert_quiescent()


@pytest.mark.parametrize("kv_dtype", [None, "int8"], ids=["float", "int8"])
def test_engine_failover_adopts_the_stored_prefix(kv_dtype, tmp_path):
    """Turn 1 on engine A spills to the store; A closes; turn 2 on engine B
    (same root, never saw the conversation) adopts the prefix from the
    store and gives the tokens of an engine without any tier."""
    sp = SamplingParams(max_new_tokens=6, temperature=0.0)
    a = LLMEngine(CFG, spec(tmp_path, kv_cache_dtype=kv_dtype), seed=0,
                  device="cpu")
    try:
        out1 = a.generate(list(TURN1), sp)
        wait_spilled(a, 2)
        assert a.kv_pages_remote() == 2
    finally:
        a.stop()
    base = LLMEngine(CFG, spec(enable_prefix_caching=False,
                               kv_cache_dtype=kv_dtype), seed=0, device="cpu")
    b = LLMEngine(CFG, spec(tmp_path, kv_cache_dtype=kv_dtype), seed=0,
                  device="cpu")
    try:
        turn2 = TURN1 + out1 + [3, 1, 4, 1, 5, 9, 2, 6] * 3
        assert base.generate(list(TURN1), sp) == out1
        want = base.generate(list(turn2), sp)
        assert b.generate(list(turn2), sp) == want
        tier = b.kv_tier_stats()
        assert tier["remote_registry_hits"] >= 2, tier
        assert tier["pages_promoted_remote"] >= 2, tier
        assert tier["prefix_hits"] >= 1, tier
        quiesce(b)
    finally:
        b.stop()
        base.stop()


def test_engine_fabric_sig_and_drain_are_the_jax_engine_s(tmp_path):
    """The fabric signature is the JAX engine's string (fp32, bf16 and
    int8 pools); ``drain_kv_to_remote`` publishes a cached conversation
    that never aged, and the JAX engine on the same root adopts it with
    the JAX tier-free engine's greedy tokens."""
    jax = pytest.importorskip("jax")
    from kubeflow_tpu.core.serving import BatchingSpec as JBatchingSpec
    from kubeflow_tpu.models import config as jconfig
    from kubeflow_tpu.models import decoder as jdec
    from kubeflow_tpu.serve import engine as jengine
    from kubeflow_tpu_torch.models.convert import params_from_jax

    jcfg = jconfig.preset("tiny", vocab_size=512, dtype="float32")
    jparams = jdec.init_decoder_params(jax.random.PRNGKey(0), jcfg)
    kw = dict(max_batch_size=2, max_seq_len=96, paged=True, page_size=16,
              chunked_prefill_tokens=16, decode_steps=4, host_kv_pages=32,
              kv_demote_after_s=60.0, kv_remote_after_s=60.0,
              remote_kv_root=str(tmp_path))
    for q in (None, "int8"):
        j = jengine.LLMEngine(jcfg, JBatchingSpec(**kw, kv_cache_dtype=q),
                              params=jparams)
        t = LLMEngine(CFG, BatchingSpec(**kw, kv_cache_dtype=q), seed=0,
                      device="cpu")
        try:
            assert t._kvtier.fabric_sig == j._kvtier.fabric_sig
        finally:
            j.stop()
            t.stop()
    # A bf16 pool writes "full" too, never its dtype.
    bcfg = tconfig.preset("tiny", vocab_size=512, dtype="bfloat16")
    bf = LLMEngine(bcfg, BatchingSpec(**kw), seed=0, device="cpu")
    try:
        assert bf._kvtier.fabric_sig == (
            f"L{bcfg.n_layers}.H{bcfg.n_kv_heads}.D{bcfg.head_dim}.P16.full")
    finally:
        bf.stop()

    sp = SamplingParams(max_new_tokens=6)
    want1 = jengine.LLMEngine(jcfg, JBatchingSpec(
        max_batch_size=2, max_seq_len=96, paged=True, page_size=16,
        chunked_prefill_tokens=16, enable_prefix_caching=False),
        params=jparams)
    out1 = want1.generate(list(TURN1), jengine.SamplingParams(
        max_new_tokens=6))
    turn2 = TURN1 + out1 + [9, 9, 8, 7] * 6
    want2 = want1.generate(list(turn2), jengine.SamplingParams(
        max_new_tokens=6))
    t = LLMEngine(CFG, BatchingSpec(**kw), device="cpu",
                  params=params_from_jax(jax.tree.map(np.asarray, jparams),
                                         device="cpu"))
    try:
        assert t.generate(list(TURN1), sp) == out1
        assert t.drain_kv_to_remote() == 2
        assert t.kv_pages_remote() == 2 and t.kv_pages_cached() == 0
    finally:
        t.stop()
    j = jengine.LLMEngine(jcfg, JBatchingSpec(**kw), params=jparams)
    try:
        assert j.generate(list(turn2), jengine.SamplingParams(
            max_new_tokens=6)) == want2
        tier = j.kv_tier_stats()
        assert tier["remote_registry_hits"] >= 2, tier
        assert tier["pages_promoted_remote"] >= 2, tier
        assert tier["prefix_hits"] >= 1, tier
    finally:
        j.stop()


def test_blob_of_another_float_dtype_is_cast_on_upload(tmp_path):
    """An fp32 pool's blobs promoted into a bf16 pool (both "full"): the
    promoted pages hold the fp32 pages' values cast to bf16."""
    a = LLMEngine(CFG, spec(tmp_path), seed=0, device="cpu")
    try:
        a.generate(list(TURN1), SamplingParams(max_new_tokens=2))
        pages = [p for p in a._allocator.reclaimable_lru()
                 if len(a._kvtier._by_page[p].block) == 16]
        chain = {a._kvtier._by_page[p].block: p for p in pages}
        want = {blk: (a.cache["k"][:, p].clone(), a.cache["v"][:, p].clone())
                for blk, p in chain.items()}
        assert a.drain_kv_to_remote() == 2
    finally:
        a.stop()
    b = LLMEngine(tconfig.preset("tiny", vocab_size=512, dtype="bfloat16"),
                  spec(tmp_path), seed=0, device="cpu")
    try:
        assert b.cache["k"].dtype == torch.bfloat16
        assert b._kvtier.fabric_sig == a._kvtier.fabric_sig
        hit, covered = b._kvtier.match_and_acquire(TURN1[:33], owner="x")
        assert covered == 32 and len(hit) == 2
        assert_store_hit(b._kvtier, pages=2)
        for j, blk in enumerate((tuple(TURN1[:16]), tuple(TURN1[16:32]))):
            k, v = want[blk]
            assert torch.equal(b.cache["k"][:, hit[j]], k.to(torch.bfloat16))
            assert torch.equal(b.cache["v"][:, hit[j]], v.to(torch.bfloat16))
        b._allocator.free(hit)
        b._allocator.assert_quiescent()
    finally:
        b.stop()
