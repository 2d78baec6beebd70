"""The port's paged KV path on the CPU (``device="cpu"``), each piece held
against the JAX package on the same seeded numpy inputs:

- ``PageAllocator``: the allocator cases of tests/test_serve_paged.py run
  through both allocators, which must hand out the same page ids and end
  with the same stats (exact);
- ``quantize_kv``/``dequantize_kv``: bit for bit, round-half-to-even ties
  included;
- ``paged_decode_attention`` (the plain version a CPU tensor takes) against
  the JAX kernel in interpret mode: 2e-5 absolute in float32, float pools
  and int8 pools (the JAX test's tolerance: the same math, fp32 sums in
  another order); poisoned unmapped pages must change nothing (exact);
- the radix prefix index: the scenarios of tests/test_serve_kvtier.py
  through both indexes — same matches, copies, stats (exact);
- the paged device steps (``copy_pages``, ``context_bucket``,
  ``paged_chunk_prefill``, ``paged_decode_multi``) on the tiny float32
  model: logits within 1e-5 relative, pools within 1e-5, tokens exact;
- the paged engine: greedy tokens identical to the JAX paged engine
  (``paged_attn_impl="gather"``) for the gather and plain-kernel paths,
  float and int8 pools, and to the port's contiguous engine; shared-prefix
  reuse, radix copy-on-write, pool-pressure preemption and a starved
  concurrent chunking, every one ending with no page referenced."""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from kubeflow_tpu.core.serving import BatchingSpec as JBatchingSpec  # noqa: E402
from kubeflow_tpu.models import config as jconfig  # noqa: E402
from kubeflow_tpu.models import decoder as jdec  # noqa: E402
from kubeflow_tpu.ops import paged_attention as jpa  # noqa: E402
from kubeflow_tpu.ops import quantization as jquant  # noqa: E402
from kubeflow_tpu.serve import engine as jengine  # noqa: E402
from kubeflow_tpu.serve import kvtier as jkvtier  # noqa: E402
from kubeflow_tpu.serve import paged as jpaged  # noqa: E402
from kubeflow_tpu_torch.core.serving import BatchingSpec  # noqa: E402
from kubeflow_tpu_torch.models import config as tconfig  # noqa: E402
from kubeflow_tpu_torch.models.convert import params_from_jax  # noqa: E402
from kubeflow_tpu_torch.ops import quantization as tquant  # noqa: E402
from kubeflow_tpu_torch.ops.paged_attention import (  # noqa: E402
    paged_decode_attention, paged_decode_ref,
)
from kubeflow_tpu_torch.serve import engine as E  # noqa: E402
from kubeflow_tpu_torch.serve import kvtier as tkvtier  # noqa: E402
from kubeflow_tpu_torch.serve import paged as tpaged  # noqa: E402
from kubeflow_tpu_torch.serve.device_state import DecodeState  # noqa: E402

ATTN_TOL = 2e-5
STEP_TOL = 1e-5

# Prompts of tests/test_serve_paged.py's exact-match case.
PROMPTS = [[5, 17, 3, 99, 42], list(range(1, 50)), [7] * 20,
           [9, 8, 7, 6, 5, 4]]


def _t(a):
    return torch.from_numpy(np.array(a))     # a writable copy


# -- page allocator ----------------------------------------------------------------

def _alloc_free_refcount(A, log):
    a = A(4, 8)
    p = a.alloc(3)
    log += [p, a.available()]
    a.incref([p[0]])
    a.free(p)
    log.append(a.available())                # p[0] still referenced
    a.free([p[0]])
    log.append(a.available())
    return a


def _exhaustion(A, log):
    a = A(2, 8)
    log.append(a.alloc(2))
    try:
        a.alloc(1)
    except Exception as exc:                 # each package's own class
        log.append(type(exc).__name__)
    return a


def _prefix_match_and_eviction(A, log):
    a = A(4, 4)
    toks = list(range(1, 13))                # 3 full pages
    pages = a.alloc(3)
    a.register_prefix(toks, pages)
    a.free(pages)
    hit = a.match_prefix(toks + [99])
    log += [pages, hit, a.cached()]
    a.free(hit)
    log.append(a.alloc(4))                   # evicts the cached pages LRU
    log.append(a.match_prefix(toks + [99]))
    return a


def _match_capped(A, log):
    a = A(4, 4)
    toks = list(range(8))                    # exactly 2 pages
    pages = a.alloc(2)
    a.register_prefix(toks, pages)
    log.append(a.match_prefix(toks))         # (8-1)//4 = 1 page at most
    return a


def _match_cap_edges(A, log):
    a = A(8, 4)
    toks = list(range(1, 13))
    pages = a.alloc(3)
    a.register_prefix(toks, pages)
    a.free(pages)
    log.append(a.match_prefix(toks))
    h = a.match_prefix(toks + [99])
    log.append(h)
    a.free(h)
    log += [a.match_prefix(toks[:5]), a.match_prefix(toks[:4])]
    return a


def _chain_break(A, log):
    a = A(4, 4)
    toks = list(range(1, 13))
    pages = a.alloc(3)
    a.register_prefix(toks, pages)
    a.free(pages)
    key = a._key_of.pop(pages[1])            # the middle page's content goes
    a._by_key.pop(key)
    hit = a.match_prefix(toks + [99])
    log.append(hit)
    a.free(hit)
    return a


def _owner_stamps(A, log):
    a = A(6, 4)
    p = a.alloc(2, owner="req-a")
    q = a.alloc(1, owner="req-b")
    a.incref(p[:1], owner="req-c")
    log.append(sorted(a.leak_report_by_owner().items()))
    a.free(p + q)
    log += [a.leak_report(), sorted(a.leak_report_by_owner().items())]
    a.free(p[:1])
    a.assert_quiescent()
    return a


@pytest.mark.parametrize("scenario", [
    _alloc_free_refcount, _exhaustion, _prefix_match_and_eviction,
    _match_capped, _match_cap_edges, _chain_break, _owner_stamps],
    ids=lambda f: f.__name__.strip("_"))
def test_page_allocator_matches_the_jax_allocator(scenario, monkeypatch):
    monkeypatch.setenv("KFTPU_SANITIZE", "refcount")
    logs = {}
    for name, A in (("jax", jpaged.PageAllocator),
                    ("torch", tpaged.PageAllocator)):
        log: list = []
        a = scenario(A, log)
        logs[name] = (log, dict(a.stats), a.leak_report(), sorted(a._free),
                      list(a._reclaimable))
    assert logs["torch"] == logs["jax"]


def test_page_allocator_cases_hold():
    """The JAX test's own assertions, on the port's allocator."""
    log: list = []
    _alloc_free_refcount(tpaged.PageAllocator, log)
    assert len(set(log[0])) == 3 and log[1:] == [1, 3, 4]
    log = []
    a = _prefix_match_and_eviction(tpaged.PageAllocator, log)
    assert log[1] == log[0] and log[4] == [] and a.stats["evictions"] >= 1
    log = []
    _match_cap_edges(tpaged.PageAllocator, log)
    assert [len(h) for h in log] == [2, 3, 1, 0]
    with pytest.raises(tpaged.PagePoolExhausted):
        tpaged.PageAllocator(1, 4).alloc(2)


# -- int8 KV quantization ------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_bit_for_bit(dtype):
    r = np.random.default_rng(3)
    x = (r.standard_normal((4, 5, 3, 16))
         * r.uniform(0.01, 50.0, (4, 5, 3, 1))).astype(np.float32)
    # Ties: amax 127 makes the scale exactly 1, so x.5 values round half to
    # even; an all-zero row takes the 1e-8 floor.
    x[0, 0, 0] = [127.0, 2.5, -2.5, 0.5, -0.5, 1.5, -1.5, 3.5, 4.5, -126.5,
                  0.0, 6.5, -7.5, 8.5, 9.5, -10.5]
    x[0, 0, 1] = 0.0
    jx = jnp.asarray(x).astype(dtype)
    tx = _t(x).to(getattr(torch, dtype))
    jq, js = jquant.quantize_kv(jx)
    tq, ts = tquant.quantize_kv(tx)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    assert np.array_equal(tq.numpy(), np.asarray(jq))
    assert np.array_equal(ts.numpy(), np.asarray(js))
    assert tq[0, 0, 0, 1:10].tolist() == [2, -2, 0, 0, 2, -2, 4, 4, -126]
    jd = jquant.dequantize_kv(jq, js, jnp.float32)
    td = tquant.dequantize_kv(tq, ts, torch.float32)
    assert np.array_equal(td.numpy(), np.asarray(jd))


# -- paged decode attention (plain version vs the JAX kernel) -------------------------

def _setup(B=3, H=8, K=2, D=16, pg=8, P=10):
    """The JAX test's shapes and table (tests/test_serve_paged.py)."""
    r = np.random.default_rng(0)
    pool_k = r.normal(size=(P, pg, K, D)).astype(np.float32)
    pool_v = r.normal(size=(P, pg, K, D)).astype(np.float32)
    q = r.normal(size=(B, 1, H, D)).astype(np.float32)
    table = np.asarray([[3, 1, 7, -1], [0, 2, -1, -1], [5, 4, 9, 6]],
                       np.int32)
    lengths = np.asarray([19, 9, 30], np.int32)
    return q, pool_k, pool_v, table, lengths


def _both(q, pk, pv, table, lengths, pks=None, pvs=None):
    want = jpa.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv), jnp.asarray(table),
        jnp.asarray(lengths),
        pool_ks=None if pks is None else jnp.asarray(pks),
        pool_vs=None if pvs is None else jnp.asarray(pvs), interpret=True)
    got = paged_decode_attention(
        _t(q), _t(pk), _t(pv), _t(table), _t(lengths).long(),
        pool_ks=None if pks is None else _t(pks),
        pool_vs=None if pvs is None else _t(pvs))
    return got.numpy(), np.asarray(want)


def test_paged_decode_matches_the_jax_kernel():
    got, want = _both(*_setup())
    assert got.shape == (3, 1, 8, 16)
    assert np.max(np.abs(got - want)) < ATTN_TOL


def test_paged_decode_int8_matches_the_jax_kernel():
    q, pk, pv, table, lengths = _setup()
    qk, sk = (np.asarray(a) for a in jquant.quantize_kv(jnp.asarray(pk)))
    qv, sv = (np.asarray(a) for a in jquant.quantize_kv(jnp.asarray(pv)))
    got, want = _both(q, qk, qv, table, lengths, sk, sv)
    assert np.max(np.abs(got - want)) < ATTN_TOL
    full, _ = _both(q, pk, pv, table, lengths)
    assert np.max(np.abs(got - full)) < 0.05     # the scales were applied


def test_paged_decode_ignores_unmapped_pages_and_dead_rows():
    q, pk, pv, table, lengths = _setup()
    base, _ = _both(q, pk, pv, table, lengths)
    pk[8], pv[8] = 999.0, 999.0                  # no table names page 8
    poisoned, want = _both(q, pk, pv, table, lengths)
    assert np.array_equal(poisoned, base)
    assert np.max(np.abs(poisoned - want)) < ATTN_TOL
    table[1] = -1                                # a row with no mapped page
    dead, want = _both(q, pk, pv, table, lengths)
    assert not dead[1].any() and not np.asarray(want)[1].any()


def test_paged_decode_refuses_what_the_jax_kernel_refuses():
    q, pk, pv, table, lengths = _setup()
    qk, sk = tquant.quantize_kv(_t(pk))
    qv, _ = tquant.quantize_kv(_t(pv))
    with pytest.raises(ValueError, match="together"):
        paged_decode_attention(_t(q), qk, qv, _t(table), _t(lengths),
                               pool_ks=sk)
    with pytest.raises(ValueError, match="one token"):
        paged_decode_attention(_t(q).expand(3, 2, 8, 16), _t(pk), _t(pv),
                               _t(table), _t(lengths))
    with pytest.raises(ValueError, match="multiple"):
        paged_decode_attention(_t(q)[:, :, :7], _t(pk), _t(pv), _t(table),
                               _t(lengths))


def test_paged_decode_wrapper_contract():
    """A CPU tensor takes the plain version and counts no launch; a tensor
    that is neither on the CPU nor on a card raises."""
    before = paged_decode_attention.launches
    q, pk, pv, table, lengths = (_t(a) for a in _setup())
    assert torch.equal(paged_decode_attention(q, pk, pv, table, lengths),
                       paged_decode_ref(q, pk, pv, table, lengths))
    assert paged_decode_attention.launches == before
    meta = [torch.empty(a.shape, dtype=torch.bfloat16, device="meta")
            for a in (q, pk, pv)]
    with pytest.raises(ValueError):
        paged_decode_attention(*meta, table, lengths)


# -- radix prefix index ----------------------------------------------------------------

PG = 4


def _index(pkg, num_pages=16):
    """A radix index over a real allocator, recording the COW copies."""
    A, R = ((jpaged.PageAllocator, jkvtier.RadixPrefixIndex) if pkg == "jax"
            else (tpaged.PageAllocator, tkvtier.RadixPrefixIndex))
    copies: list = []
    alloc = A(num_pages, PG, enable_prefix_caching=True)
    idx = R(alloc, PG, copy_pages_fn=lambda s, d: copies.append(
        (list(s), list(d))))
    return idx, alloc, copies


def _full_blocks(idx, alloc, log):
    toks = list(range(1, 13))
    pages = alloc.alloc(3, owner="a")
    idx.insert(toks, pages, 12)
    hit, covered = idx.match_and_acquire(toks, owner="b")
    log += [pages, hit, covered, alloc.ref(pages[0])]
    alloc.free(hit)
    alloc.free(pages)


def _cap_one_short(idx, alloc, log):
    toks = list(range(1, 9))
    pages = alloc.alloc(2, owner="a")
    idx.insert(toks, pages, 8)
    log.append(idx.match_and_acquire(toks, owner="b"))
    log.append(idx.match_and_acquire(toks + [99], owner="c"))


def _divergence_cow(idx, alloc, log):
    pages = alloc.alloc(2, owner="a")
    idx.insert([1, 2, 3, 4, 5, 6, 7, 8], pages, 8)
    alloc.free(pages)
    hit, covered = idx.match_and_acquire([1, 2, 3, 4, 5, 6, 99, 98, 97],
                                         owner="b")
    log += [pages, hit, covered, alloc.ref(pages[1])]
    alloc.free(hit)


def _partial_upgrade(idx, alloc, log):
    toks = [1, 2, 3, 4, 5, 6]
    pages = alloc.alloc(2, owner="a")
    idx.insert(toks, pages, 6)
    idx.insert(toks + [7], pages, 7)
    log.append(idx.match_and_acquire(toks + [7, 8, 9], owner="b"))


def _eviction_cascade(idx, alloc, log):
    toks = list(range(1, 17))
    pages = alloc.alloc(4, owner="a")
    idx.insert(toks, pages, 16)
    alloc.free(pages)
    fresh = alloc.alloc(len(alloc._free) + alloc.cached(), owner="b")
    log += [fresh, idx.match_and_acquire(toks + [99], owner="c")]
    alloc.free(fresh)


def _cow_evicts_its_source(idx, alloc, log):
    pages = alloc.alloc(len(alloc._free), owner="a")
    idx.insert([1, 2, 3, 4, 5, 6, 7, 8], pages[:2], 8)
    alloc.free(pages)
    log.append(alloc.alloc(len(pages) - 2, owner="x"))   # only 2 left
    hit = idx.match_and_acquire([1, 2, 3, 4, 5, 6, 99, 98], owner="b")
    log.append(hit)
    alloc.free(hit[0])
    alloc.free(log[-2])


def _leaf_first_release(idx, alloc, log):
    toks = list(range(1, 17))
    pages = alloc.alloc(4, owner="a")
    idx.insert(toks, pages, 16)
    alloc.free(list(reversed(pages)))
    filler = alloc.alloc(len(alloc._free) + 1, owner="b")   # evicts a leaf
    log += [filler, idx.match_and_acquire(toks[:8] + [99], owner="c")]


@pytest.mark.parametrize("scenario", [
    _full_blocks, _cap_one_short, _divergence_cow, _partial_upgrade,
    _eviction_cascade, _cow_evicts_its_source, _leaf_first_release],
    ids=lambda f: f.__name__.strip("_"))
def test_radix_index_matches_the_jax_index(scenario):
    logs = {}
    for pkg in ("jax", "torch"):
        idx, alloc, copies = _index(pkg)
        log: list = []
        scenario(idx, alloc, log)
        stats = {k: v for k, v in idx.snapshot().items()
                 if k in tkvtier.RadixPrefixIndex(
                     tpaged.PageAllocator(1, PG), PG).stats}
        logs[pkg] = (log, copies, stats, dict(alloc.stats),
                     alloc.leak_report(), sorted(alloc.retained))
    assert logs["torch"] == logs["jax"]


def test_radix_index_cases_hold():
    """The JAX tests' own assertions, on the port's index."""
    idx, alloc, copies = _index("torch")
    log: list = []
    _full_blocks(idx, alloc, log)
    pages, hit, covered, ref0 = log
    assert hit[:2] == pages[:2] and covered == 11 and ref0 == 2
    assert copies == [([pages[2]], [hit[2]])]
    alloc.assert_quiescent()
    idx, alloc, copies = _index("torch", num_pages=4)
    log = []
    _eviction_cascade(idx, alloc, log)
    assert log[1] == ([], 0) and idx.stats["nodes"] == 0
    assert idx.stats["evictions"] >= 1
    idx, alloc, copies = _index("torch")
    log = []
    _cow_evicts_its_source(idx, alloc, log)
    assert log[1][1] == PG and copies == []      # the tail's source died
    alloc.assert_quiescent()


# -- paged device steps ------------------------------------------------------------------

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


def _pools(cfg, P, pg, quant, seed=0):
    """Seeded pools for both packages: JAX's ``[L, P, pg, K, D]`` and the
    port's with the sink page appended."""
    r = np.random.default_rng(seed)
    shape = (cfg.n_layers, P, pg, cfg.n_kv_heads, cfg.head_dim)
    k = r.normal(size=shape).astype(np.float32)
    v = r.normal(size=shape).astype(np.float32)
    if quant:
        (k, ks), (v, vs) = (tuple(np.asarray(a) for a in
                                  jquant.quantize_kv(jnp.asarray(x)))
                            for x in (k, v))
        planes = {"k": k, "v": v, "ks": ks, "vs": vs}
    else:
        planes = {"k": k, "v": v}
    jcache = {n: jnp.asarray(a) for n, a in planes.items()}
    tcache = {n: torch.cat([_t(a), torch.zeros_like(_t(a)[:, :1])], dim=1)
              for n, a in planes.items()}
    return jcache, tcache


def test_copy_pages_matches_jax(cfg):
    jcache, tcache = _pools(cfg, 6, 4, quant=True)
    src, dst = np.asarray([4, 1, 0, 0], np.int32), \
        np.asarray([2, 5, -1, -1], np.int32)           # pow2 padding: -1
    want = jpaged.copy_pages(jcache, jnp.asarray(src), jnp.asarray(dst))
    tpaged.copy_pages(tcache, _t(src), _t(dst))
    for n in ("k", "v", "ks", "vs"):
        assert np.array_equal(tcache[n][:, :6].numpy(), np.asarray(want[n]))


def test_context_bucket_matches_jax():
    for pos, chunk, pg, mpp in [(0, 32, 16, 8), (48, 32, 16, 8),
                                (100, 32, 16, 8), (5, 16, 16, 3),
                                (0, 128, 128, 16), (1900, 512, 128, 16)]:
        assert tpaged.context_bucket(pos, chunk, pg, mpp) == \
            jpaged.context_bucket(pos, chunk, pg, mpp)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / (1.0 + np.abs(b))))


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
def test_chunk_prefill_then_decode_matches_jax(quant, cfg, jcfg, params,
                                               jparams):
    """Two chunks of a 40-token prompt, the second starting mid-page, then
    four decode+sample steps for two live slots and one dead one (its
    writes land on the sink, never on a real page)."""
    pg, mpp, P, C = 8, 8, 20, 16
    jcache, tcache = _pools(cfg, P, pg, quant, seed=1)
    prompt = np.random.default_rng(2).integers(3, 250, 40)
    row = np.asarray([3, 7, 1, 9, 12, 4, -1, -1], np.int32)
    for start, valid in ((0, 16), (16, 13), (29, 11)):
        toks = np.zeros((1, C), np.int32)
        toks[0, :valid] = prompt[start:start + valid]
        ctx = tpaged.context_bucket(start, C, pg, mpp)
        jl, jcache = jpaged.paged_chunk_prefill(
            jparams, jcache, jnp.asarray(toks), jnp.asarray(row),
            jnp.int32(start), jnp.int32(valid), jcfg, context_pages=ctx)
        tl = tpaged.paged_chunk_prefill(params, tcache, _t(toks).long(),
                                        _t(row), start, valid, cfg,
                                        context_pages=ctx)
        assert _rel(tl[:valid].numpy(), np.asarray(jl)[:valid]) < STEP_TOL
    for n in jcache:
        assert _rel(tcache[n][:, :P].numpy(), np.asarray(jcache[n])) \
            < STEP_TOL
    table = np.stack([row, np.asarray([2, 0, 5, -1, -1, -1, -1, -1]),
                      np.full(mpp, -1)]).astype(np.int32)
    b = 3
    state = dict(tokens=np.asarray([int(prompt[-1]), 11, 0], np.int32),
                 lengths=np.asarray([40, 21, 0], np.int32),
                 live=np.asarray([True, True, False]),
                 temps=np.zeros(b, np.float32), top_k=np.zeros(b, np.int32),
                 top_p=np.ones(b, np.float32),
                 stops=np.full(b, -1, np.int32),
                 budgets=np.asarray([4, 4, 0], np.int32))
    names = ("tokens", "lengths", "live", "temps", "top_k", "top_p", "stops",
             "budgets")
    jout, jcache, *jrest = jpaged.paged_decode_multi(
        jparams, {**jcache, "table": jnp.asarray(table)},
        *(jnp.asarray(state[n]) for n in names), jax.random.PRNGKey(0),
        jcfg, 4, sample_mode="greedy", attn_impl="gather")
    sink = {n: t[:, P].clone() for n, t in tcache.items()}
    for impl in ("gather", "pallas"):
        cache = {n: t.clone() for n, t in tcache.items()}
        tout, *trest = tpaged.paged_decode_multi(
            params, {**cache, "table": _t(table)},
            *(_t(state[n]).long() if state[n].dtype == np.int32
              else _t(state[n]) for n in names), torch.Generator(), cfg, 4,
            sample_mode="greedy", attn_impl=impl)
        assert tout.tolist() == np.asarray(jout).tolist()
        for got, want in zip(trest, jrest):
            assert got.tolist() == np.asarray(want).tolist()
        for n in jcache:
            if n == "table":
                continue
            assert _rel(cache[n][:, :P].numpy(), np.asarray(jcache[n])) \
                < STEP_TOL
        # The dead row wrote only to the sink page.
        assert any(not torch.equal(cache[n][:, P], sink[n]) for n in sink)


def test_decode_writes_never_wrap_onto_the_last_real_page():
    """An unmapped write position (table -1) or a dead row aims at the sink
    (index P), not at page -1, which would wrap onto page P - 1."""
    table = torch.tensor([[4, -1], [2, 3], [1, 0]], dtype=torch.int32)
    pidx, off = tpaged._write_index(
        table, torch.tensor([9, 9, 3]), torch.tensor([True, True, False]),
        page_size=8, sink=6)
    assert pidx.tolist() == [6, 3, 6] and off.tolist() == [1, 1, 3]


def test_decode_state_syncs_only_dirty_table_rows():
    ds = DecodeState(3, torch.device("cpu"), mpp=4)
    assert ds.table.tolist() == [[-1] * 4] * 3
    ds.mark_row(1)
    ds.sync_rows(lambda i: np.asarray([7, 2, -1, -1], np.int32))
    assert ds.table[1].tolist() == [7, 2, -1, -1]
    assert ds.table[0].tolist() == [-1] * 4
    assert ds.stats == {"full_state_uploads": 1, "slot_syncs": 0,
                        "full_table_uploads": 1, "table_row_syncs": 1}
    ds.sync_rows(lambda i: pytest.fail("nothing is dirty"))


# -- the paged engine ------------------------------------------------------------------------

def _spec(**kw):
    base = dict(max_batch_size=4, max_seq_len=96, paged=True, page_size=16,
                chunked_prefill_tokens=32)
    base.update(kw)
    return base


def _run(eng, prompts, n_new=8, max_steps=2000):
    reqs = [eng.submit(p, E.SamplingParams(max_new_tokens=n_new))
            for p in prompts]
    for _ in range(max_steps):
        if all(r.done.is_set() for r in reqs):
            break
        eng.step()
    assert all(r.done.is_set() for r in reqs), "requests did not finish"
    return [r.output_tokens for r in reqs]


def _port(cfg, params, **kw):
    return E.LLMEngine(cfg, BatchingSpec(**_spec(**kw)), params=params,
                       device="cpu")


@pytest.fixture(scope="module")
def jax_paged_tokens(jcfg, jparams):
    """The JAX paged engine's greedy tokens (gather attention), float and
    int8 pools."""
    out = {}
    for kvd in (None, "int8"):
        eng = jengine.LLMEngine(jcfg, JBatchingSpec(**_spec(
            paged_attn_impl="gather", kv_cache_dtype=kvd)), params=jparams)
        reqs = [eng.submit(p, jengine.SamplingParams(max_new_tokens=8))
                for p in PROMPTS]
        while not all(r.done.is_set() for r in reqs):
            eng.step()
        out[kvd] = [list(r.output_tokens) for r in reqs]
    return out


@pytest.mark.parametrize("impl", ["gather", "pallas"])
@pytest.mark.parametrize("kvd", [None, "int8"], ids=["float", "int8"])
def test_paged_engine_matches_the_jax_paged_engine(impl, kvd, cfg, params,
                                                   jax_paged_tokens):
    eng = _port(cfg, params, paged_attn_impl=impl, kv_cache_dtype=kvd)
    assert eng.paged_attn_impl == impl
    assert _run(eng, PROMPTS) == jax_paged_tokens[kvd]
    eng._allocator.assert_quiescent()
    assert eng.kv_pages_in_use() == 0 and eng.kv_pages_cached() > 0


def test_paged_and_contiguous_engines_agree(cfg, params, jax_paged_tokens):
    contig = E.LLMEngine(cfg, BatchingSpec(max_batch_size=4, max_seq_len=96,
                                           prefill_buckets=[16, 32, 64]),
                         params=params, device="cpu")
    want = _run(contig, PROMPTS)
    assert want == jax_paged_tokens[None]
    assert _run(_port(cfg, params, prefix_index="flat"), PROMPTS) == want
    assert _run(_port(cfg, params, enable_prefix_caching=False),
                PROMPTS) == want


def test_paged_engine_resolution_and_density(cfg, params, jcfg, jparams):
    eng = _port(cfg, params)
    assert eng.paged_attn_impl == "gather"          # "auto" on the CPU
    q = _port(cfg, params, kv_cache_dtype="int8")
    jeng = jengine.LLMEngine(jcfg, JBatchingSpec(**_spec(
        kv_cache_dtype="int8")), params=jparams)
    assert q.kv_pool_density() == jeng.kv_pool_density()
    assert q.cache["k"].shape[1] == q._num_pages + 1    # + the sink page
    assert E.LLMEngine(cfg, BatchingSpec(max_batch_size=2, max_seq_len=96),
                       params=params, device="cpu").kv_pool_density() == {}
    with pytest.raises(ValueError):
        _port(cfg, params, paged_attn_impl="flash")
    with pytest.raises(ValueError):
        _port(cfg, params, chunked_prefill_tokens=24)
    with pytest.raises(ValueError):
        _port(cfg, params, max_pages=2)


@pytest.mark.parametrize("overrides", [
    {"host_kv_pages": 8}, {"host_kv_pages": 8, "remote_kv_root": "kv"}])
def test_host_and_remote_tiers_raise(overrides, cfg):
    with pytest.raises(NotImplementedError):
        E.LLMEngine(cfg, BatchingSpec(**_spec(**overrides)), device="cpu")


def test_paged_engine_without_device_raises_here(cfg):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        E.LLMEngine(cfg, BatchingSpec(**_spec()))


def test_shared_prefix_reuses_pages(cfg, params):
    system = list(range(40, 90))             # a 50-token shared prefix
    eng = _port(cfg, params)
    first = _run(eng, [system + [1, 2, 3]], n_new=6)
    hits = eng._allocator.stats["prefix_hits"]
    second = _run(eng, [system + [7, 8, 9]], n_new=6)
    assert eng._allocator.stats["prefix_hits"] == hits + 1
    assert eng.kv_tier_stats()["tokens_matched"] >= 48
    cold = _port(cfg, params, enable_prefix_caching=False)
    assert _run(cold, [system + [1, 2, 3], system + [7, 8, 9]], n_new=6) \
        == first + second
    eng._allocator.assert_quiescent()


def test_radix_copy_on_write_keeps_outputs(cfg, params):
    """A prompt that leaves a registered one inside a page shares the full
    pages and copies the shared part of the diverging one."""
    base = list(range(3, 43))                # 40 tokens: 2 pages + 8
    fork = base[:37] + [200, 201, 202, 203, 204]
    eng = _port(cfg, params)
    _run(eng, [base], n_new=4)
    got = _run(eng, [fork], n_new=6)
    st = eng.kv_tier_stats()
    assert st["cow_copies"] >= 1 and st["tokens_cow"] >= 5
    cold = _port(cfg, params, enable_prefix_caching=False)
    assert got == _run(cold, [fork], n_new=6)
    eng._allocator.assert_quiescent()


def test_conversation_turn_matches_through_the_history(cfg, params):
    eng = _port(cfg, params)
    prompt = list(range(10, 40))
    out = _run(eng, [prompt], n_new=10)[0]
    turn2 = prompt + out + [5, 6, 7]
    before = eng.kv_tier_stats()["tokens_matched"]
    got = _run(eng, [turn2], n_new=5)
    assert eng.kv_tier_stats()["tokens_matched"] - before >= len(prompt)
    assert got == _run(_port(cfg, params, enable_prefix_caching=False),
                       [turn2], n_new=5)


def test_pool_pressure_preempts_and_resumes(cfg, params):
    """8 pages of 16 hold one max-length sequence; three growing ones
    cannot fit: the youngest is preempted, recomputed and resumed, and the
    tokens equal the contiguous engine's."""
    prompts = [list(range(1, 30)), list(range(2, 60)), list(range(3, 40))]
    eng = _port(cfg, params, max_seq_len=128, max_pages=8, chunked_prefill_tokens=16,
                enable_prefix_caching=False)
    got = _run(eng, prompts, n_new=24)
    assert eng.metrics.snapshot()["preemptions"] >= 1
    contig = E.LLMEngine(cfg, BatchingSpec(max_batch_size=4, max_seq_len=128,
                                           prefill_buckets=[16, 64]),
                         params=params, device="cpu")
    assert got == _run(contig, prompts, n_new=24)
    eng._allocator.assert_quiescent()


def test_starved_concurrent_chunkings_do_not_deadlock(cfg, params):
    """Two 80-token prompts whose prefills together exceed the pool: the
    starved chunking aborts and requeues instead of waiting forever."""
    a, b = list(range(1, 81)), list(range(2, 82))
    eng = _port(cfg, params, max_seq_len=128, max_pages=8,
                chunked_prefill_tokens=16, enable_prefix_caching=False,
                max_concurrent_prefills=2)
    got = _run(eng, [a, b], n_new=6)
    assert eng.metrics.snapshot()["preemptions"] >= 1    # the abort ran
    solo = _port(cfg, params, max_seq_len=128, chunked_prefill_tokens=16,
                 enable_prefix_caching=False, max_concurrent_prefills=1)
    assert got == _run(solo, [a, b], n_new=6)
    eng._allocator.assert_quiescent()


def test_cancel_and_refcount_owners(cfg, params, monkeypatch):
    """Under ``KFTPU_SANITIZE=refcount`` a mid-flight request's pages are
    stamped with its id; cancelling it leaves nothing referenced."""
    monkeypatch.setenv("KFTPU_SANITIZE", "refcount")
    eng = _port(cfg, params)
    req = eng.submit(list(range(5, 45)), E.SamplingParams(max_new_tokens=40))
    for _ in range(3):
        eng.step()
    assert set(eng._allocator.leak_report_by_owner()) == {req.id}
    req.cancel()
    eng.step()
    assert req.finish_reason == "cancelled"
    assert eng._allocator.leak_report_by_owner() == {}
    eng._allocator.assert_quiescent()
