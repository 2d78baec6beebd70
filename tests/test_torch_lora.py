"""Multi-tenant LoRA in the port (``serve/lora.py`` and its engine, paged,
radix-index and server paths) on the CPU, held against the JAX package on
the same numpy inputs (seeded), fp32, the tiny preset:

- ``lora_contrib`` / ``apply_lora_layer`` against the JAX functions: within
  1e-6 of the reference's magnitude (at least 1); rows with adapter index
  -1 bit-equal to the base projection;
- the registry cases of tests/test_serve_lora.py through the port's and
  the JAX registries side by side (same slots, hits, loads, evictions);
- adapter blobs across the packages (equal arrays both ways) and a lazy
  pull from an artifact-store root the JAX store wrote;
- greedy tokens under every adapter equal the JAX LoRA engine's (dense,
  paged, int8 paged; a mixed batch; a chunked prefill) and the port's
  merged-weights engine's; base rows equal a LoRA-free engine's (exact);
- ``chain_keys`` namespaces and the remote tier's namespaced keys equal the
  JAX package's, and a namespaced spill crosses JAX↔port; two adapters
  never share KV;
- lifecycle: unknown adapter ``KeyError``, slot backpressure requeues,
  cancel releases the reference, the ``engine.adapter_load`` span; the
  ``LoRASpec``/``BatchingSpec`` errors equal JAX's;
- the server: the model field and the header route to the adapter, an
  unknown model is a 404, /metrics shows the adapter series, and the load
  generator's ``multi_adapter`` reaches the adapters through
  ``ServerTarget``."""

import time

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from kubeflow_tpu.core.serving import BatchingSpec as JBatchingSpec  # noqa: E402
from kubeflow_tpu.core.serving import LoRASpec as JLoRASpec  # noqa: E402
from kubeflow_tpu.models import config as jconfig  # noqa: E402
from kubeflow_tpu.models import layers as jlayers  # noqa: E402
from kubeflow_tpu.models.decoder import init_decoder_params  # noqa: E402
from kubeflow_tpu.pipelines.artifacts import ArtifactStore as JStore  # noqa: E402
from kubeflow_tpu.serve import engine as jengine  # noqa: E402
from kubeflow_tpu.serve import kvtier as jkvtier  # noqa: E402
from kubeflow_tpu.serve import lora as jlora  # noqa: E402
from kubeflow_tpu.serve import paged as jpaged  # noqa: E402
from kubeflow_tpu_torch.core.headers import MODEL_HEADER  # noqa: E402
from kubeflow_tpu_torch.core.serving import BatchingSpec, LoRASpec  # noqa: E402
from kubeflow_tpu_torch.models import config as tconfig  # noqa: E402
from kubeflow_tpu_torch.models import layers as tlayers  # noqa: E402
from kubeflow_tpu_torch.models.convert import params_from_jax  # noqa: E402
from kubeflow_tpu_torch.obs.registry import parse_exposition  # noqa: E402
from kubeflow_tpu_torch.pipelines.artifacts import ArtifactStore  # noqa: E402
from kubeflow_tpu_torch.serve import kvtier as tkvtier  # noqa: E402
from kubeflow_tpu_torch.serve import lora as tlora  # noqa: E402
from kubeflow_tpu_torch.serve import paged as tpaged  # noqa: E402
from kubeflow_tpu_torch.serve.engine import LLMEngine, SamplingParams  # noqa: E402
from port_threads import torch_on_one_thread  # noqa: E402,F401

ALL_TARGETS = ("wq", "wk", "wv", "wo")
PROMPT = [5, 17, 3, 99, 42, 8, 8, 1]
LONG_PROMPT = [(7 * i) % 250 + 1 for i in range(48)]    # 3 pages of 16
CONTRIB_TOL = 1e-6


def _factors(cfg, rank, targets, seed):
    """Nonzero fp32 A/B factors from a seeded numpy generator (the JAX
    ``init_adapter_weights`` scales)."""
    rng = np.random.default_rng(seed)
    out = {}
    for t in targets:
        din, dout = tlora.target_dims(cfg, t)
        a = rng.standard_normal((cfg.n_layers, din, rank)) * (0.5 / din ** 0.5)
        b = rng.standard_normal((cfg.n_layers, rank, dout)) * (0.5 / rank ** 0.5)
        out[t] = (a.astype(np.float32), b.astype(np.float32))
    return out


# Adapter 0 targets (wq, wv); adapter 1 all four projections; adapter 2 a
# rank below the packed cap (the zero-pad path). All factors nonzero.
ADAPTERS = (("tenant-a", 4, 8.0, ("wq", "wv"), 11),
            ("tenant-b", 4, 4.0, ALL_TARGETS, 12),
            ("tenant-c", 2, 8.0, ("wq", "wv"), 13))


@pytest.fixture(scope="module")
def jcfg():
    return jconfig.preset("tiny", dtype="float32")


@pytest.fixture(scope="module")
def cfg():
    return tconfig.preset("tiny", dtype="float32")


@pytest.fixture(scope="module")
def jparams(jcfg):
    return init_decoder_params(jax.random.PRNGKey(0), jcfg)


@pytest.fixture(scope="module")
def params(jparams):
    return params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")


@pytest.fixture(scope="module")
def weights(cfg):
    return {name: (rank, alpha, _factors(cfg, rank, targets, seed))
            for name, rank, alpha, targets, seed in ADAPTERS}


def tspecs(weights):
    return [tlora.AdapterSpec(n, rank=r, alpha=a, weights=w)
            for n, (r, a, w) in weights.items()]


def jspecs(weights):
    return [jlora.AdapterSpec(n, rank=r, alpha=a, weights=w)
            for n, (r, a, w) in weights.items()]


def _spec_kw(paged, kv_dtype, slots, cls):
    return dict(max_batch_size=4, max_seq_len=128, prefill_buckets=[16, 64],
                paged=paged, page_size=16, kv_cache_dtype=kv_dtype,
                lora=cls(max_adapters=slots, rank=4, targets=ALL_TARGETS)
                if slots else cls())


def port_engine(cfg, params, *, paged=False, kv_dtype=None, slots=2,
                **over):
    kw = _spec_kw(paged, kv_dtype, slots, LoRASpec)
    kw.update(over)
    return LLMEngine(cfg, BatchingSpec(**kw), params=params, device="cpu")


def jax_engine(jcfg, jparams, *, paged=False, kv_dtype=None, slots=2):
    return jengine.LLMEngine(jcfg, JBatchingSpec(**_spec_kw(
        paged, kv_dtype, slots, JLoRASpec)), params=jparams)


def run(eng, prompt, adapter=None, n=10, **kw):
    req = eng.submit(prompt, SamplingParams(max_new_tokens=n),
                     adapter=adapter, **kw)
    while not req.done.is_set():
        eng.step()
    return req.result(5)


# -- the per-row low-rank math ---------------------------------------------------

@pytest.mark.parametrize("shape", [(3, 1, 32, 48), (2, 5, 24, 16)],
                         ids=["decode", "prefill"])
def test_lora_contrib_matches_jax(shape):
    b, s, din, dout = shape
    rng = np.random.default_rng(1)
    h = rng.standard_normal((b, s, din)).astype(np.float32)
    # Factors at the scales of init_adapter_weights.
    a = (rng.standard_normal((4, din, 8)) * 0.5 / din ** 0.5).astype(
        np.float32)
    bb = (rng.standard_normal((4, 8, dout)) * 0.5 / 8 ** 0.5).astype(
        np.float32)
    scale = np.asarray([2.0, 0.5, 1.5, 3.0], np.float32)
    aidx = np.asarray([2, -1, 0][:b], np.int32)
    want = np.asarray(jlayers.lora_contrib(jnp.asarray(h), jnp.asarray(a),
                                           jnp.asarray(bb), jnp.asarray(aidx),
                                           jnp.asarray(scale)))
    got = tlayers.lora_contrib(torch.from_numpy(h), torch.from_numpy(a),
                               torch.from_numpy(bb),
                               torch.from_numpy(aidx.astype(np.int64)),
                               torch.from_numpy(scale)).numpy()
    tol = CONTRIB_TOL * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    assert not np.any(got[1])               # base row: an exact zero delta
    # apply_lora_layer onto a headed base projection: the -1 row keeps the
    # base bits, the adapter rows match JAX.
    base = rng.standard_normal((b, s, dout // 8, 8)).astype(np.float32)
    layer_t = {"targets": {"wq": (torch.from_numpy(a), torch.from_numpy(bb))},
               "aidx": torch.from_numpy(aidx.astype(np.int64)),
               "scale": torch.from_numpy(scale)}
    layer_j = {"targets": {"wq": (jnp.asarray(a), jnp.asarray(bb))},
               "aidx": jnp.asarray(aidx), "scale": jnp.asarray(scale)}
    got = tlayers.apply_lora_layer(layer_t, "wq", torch.from_numpy(h),
                                   torch.from_numpy(base)).numpy()
    want = np.asarray(jlayers.apply_lora_layer(layer_j, "wq", jnp.asarray(h),
                                               jnp.asarray(base)))
    tol = CONTRIB_TOL * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    assert np.array_equal(got[1].view(np.int32), base[1].view(np.int32))
    # An untargeted projection is the identity.
    assert torch.equal(tlayers.apply_lora_layer(
        layer_t, "wv", torch.from_numpy(h), torch.from_numpy(base)),
        torch.from_numpy(base))


def test_bf16_delta_takes_the_jax_dtype_steps():
    """In bf16 both products return the activation dtype, the fp32 scale
    promotes, and the sum casts back: the port rounds where JAX does."""
    rng = np.random.default_rng(2)
    h = rng.standard_normal((2, 3, 16)).astype(np.float32)
    a = rng.standard_normal((2, 16, 4)).astype(np.float32)
    b = rng.standard_normal((2, 4, 8)).astype(np.float32)
    scale = np.asarray([0.75, 2.0], np.float32)
    aidx = np.asarray([1, 0], np.int32)
    jout = jlayers.lora_contrib(*(jnp.asarray(x, jnp.bfloat16)
                                  for x in (h, a, b)), jnp.asarray(aidx),
                                jnp.asarray(scale))
    tout = tlayers.lora_contrib(*(torch.from_numpy(x).bfloat16()
                                  for x in (h, a, b)),
                                torch.from_numpy(aidx.astype(np.int64)),
                                torch.from_numpy(scale))
    assert jout.dtype == jnp.float32 and tout.dtype == torch.float32
    # One bf16 rounding of each product apart at most (CPU accumulation
    # orders differ).
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout),
                               rtol=2 ** -6, atol=2 ** -6)


# -- the registry ---------------------------------------------------------------

def _registries(cfg, jcfg, **kw):
    return (tlora.AdapterRegistry(cfg, device="cpu", **kw),
            jlora.AdapterRegistry(jcfg, **kw))


def _register_three(regs, cfg):
    for reg in regs:
        for i in range(3):
            mod = tlora if isinstance(reg, tlora.AdapterRegistry) else jlora
            reg.register(mod.AdapterSpec(
                f"a{i}", rank=4, weights=_factors(cfg, 4, ("wq", "wv"), i)))


def test_acquire_release_lru_evict(cfg, jcfg):
    regs = _registries(cfg, jcfg, max_adapters=2, rank=4)
    _register_three(regs, cfg)
    logs = []
    for reg in regs:
        log = []
        s0, hot0 = reg.acquire("a0", owner="r0")
        log += [s0, hot0, reg.resident()]
        s1, _ = reg.acquire("a1", owner="r1")
        log.append(s1)
        reg.release("a0")
        reg.release("a1")
        s2, hot2 = reg.acquire("a2", owner="r2")     # a0 is the LRU ref-0
        log += [s2, hot2, sorted(reg.resident()), dict(reg.stats)]
        _, hot1b = reg.acquire("a1", owner="r3")     # resident: a hit
        log.append(hot1b)
        reg.release("a1")
        reg.release("a2")
        reg.assert_quiescent()
        log.append(reg.snapshot())
        logs.append(log)
    assert logs[0] == logs[1]
    assert logs[0][4] == logs[0][0] and logs[0][6] == ["a1", "a2"]
    assert logs[0][7]["evictions"] == 1 and logs[0][8] is False


def test_referenced_adapters_never_evict(cfg, jcfg):
    regs = _registries(cfg, jcfg, max_adapters=2, rank=4)
    _register_three(regs, cfg)
    for reg, exc in zip(regs, (tlora.AdapterSlotsExhausted,
                               jlora.AdapterSlotsExhausted)):
        reg.acquire("a0", owner="r0")
        reg.acquire("a1", owner="r1")
        assert reg.pending_pressure()
        with pytest.raises(exc):
            reg.acquire("a2", owner="r2")
        reg.release("a0")
        reg.acquire("a2", owner="r2")
        assert set(reg.resident()) == {"a1", "a2"}


def test_packed_slot_bytes_equal_the_jax_registry(cfg, jcfg, weights):
    """A hot-load writes the same padded factors and scale into the same
    slot (rank 2 zero-padded into the rank-4 buffers), in place: the
    buffers are the same tensors before and after."""
    t, j = _registries(cfg, jcfg, max_adapters=2, rank=4,
                       targets=ALL_TARGETS)
    for reg, specs in ((t, tspecs(weights)), (j, jspecs(weights))):
        for s in specs:
            reg.register(s)
    before = {k: (a.data_ptr(), b.data_ptr())
              for k, (a, b) in t.buffers["targets"].items()}
    for name in ("tenant-c", "tenant-b"):
        assert t.acquire(name) == j.acquire(name)
    assert before == {k: (a.data_ptr(), b.data_ptr())
                      for k, (a, b) in t.buffers["targets"].items()}
    np.testing.assert_array_equal(t.buffers["scale"].numpy(),
                                  np.asarray(j.buffers["scale"]))
    for k in ALL_TARGETS:
        for tb, jb in zip(t.buffers["targets"][k], j.buffers["targets"][k]):
            np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    assert t.packed_bytes() == j.packed_bytes()


def test_unknown_adapter_keyerror_and_rank_cap(cfg):
    reg = tlora.AdapterRegistry(cfg, max_adapters=2, rank=4, device="cpu")
    with pytest.raises(KeyError):
        reg.acquire("nope")
    with pytest.raises(ValueError):
        reg.register(tlora.AdapterSpec("big", rank=8))
    with pytest.raises(ValueError):
        tlora.AdapterRegistry(cfg, max_adapters=0, rank=4, device="cpu")


def test_quiescence_names_leaker(cfg, monkeypatch):
    monkeypatch.setenv("KFTPU_SANITIZE", "refcount")
    reg = tlora.AdapterRegistry(cfg, max_adapters=2, rank=4, device="cpu")
    reg.register(tlora.AdapterSpec(
        "a0", rank=4, weights=_factors(cfg, 4, ("wq", "wv"), 0)))
    reg.acquire("a0", owner="req-leaky")
    assert reg.leak_report_by_owner() == {"req-leaky": 1}
    with pytest.raises(AssertionError, match="req-leaky"):
        reg.assert_quiescent()
    reg.release("a0")
    reg.assert_quiescent()


def test_packed_bytes_and_dims(cfg, jcfg):
    reg = tlora.AdapterRegistry(cfg, max_adapters=4, rank=8,
                                targets=ALL_TARGETS, device="cpu")
    jreg = jlora.AdapterRegistry(jcfg, max_adapters=4, rank=8,
                                 targets=ALL_TARGETS)
    assert reg.packed_bytes() == jreg.packed_bytes() > 0
    for t in ALL_TARGETS:
        assert tlora.target_dims(cfg, t) == jlora.target_dims(jcfg, t)
    with pytest.raises(ValueError):
        tlora.target_dims(cfg, "mlp_up")
    # Llama-3-8B, 4 slots of rank 16 over all four projections in bf16.
    big = tconfig.preset("llama3-8b")
    n = sum(din + dout for din, dout in (tlora.target_dims(big, t)
                                         for t in ALL_TARGETS))
    assert big.n_layers * 4 * 16 * n * 2 == 109_051_904


# -- adapter blobs and the store ----------------------------------------------------

def test_blobs_cross_between_packages(cfg, weights):
    _, _, w = weights["tenant-b"]
    jblob = jlora.adapter_to_bytes(w, rank=4, alpha=12.0)
    spec = tlora.adapter_from_bytes("t", jblob)
    assert (spec.rank, spec.alpha) == (4, 12.0)
    tw = {k: (torch.from_numpy(a), torch.from_numpy(b))
          for k, (a, b) in w.items()}
    tblob = tlora.adapter_to_bytes(tw, rank=4, alpha=12.0)
    jspec = jlora.adapter_from_bytes("t", tblob)
    assert (jspec.rank, jspec.alpha) == (4, 12.0)
    for t in ALL_TARGETS:
        for i in range(2):
            np.testing.assert_array_equal(spec.weights[t][i], w[t][i])
            np.testing.assert_array_equal(jspec.weights[t][i], w[t][i])


def test_store_pull_is_lazy_from_a_jax_root(cfg, tmp_path):
    jstore = JStore(str(tmp_path))
    w = _factors(cfg, 4, ("wq", "wv"), 4)
    uri = jstore.put_bytes(jlora.adapter_to_bytes(w, rank=4, alpha=16.0))
    jstore.register("tenant-x", "1", uri)
    spec = tlora.adapter_spec_from_store(ArtifactStore(str(tmp_path)),
                                         "tenant-x", "artifact://tenant-x",
                                         rank=4)
    assert spec.weights is None              # nothing pulled yet
    got = spec.resolve_weights()
    np.testing.assert_array_equal(got["wq"][0], w["wq"][0])
    np.testing.assert_array_equal(got["wv"][1], w["wv"][1])


# -- greedy tokens against the JAX LoRA engine --------------------------------------

MODES = {"dense": dict(paged=False), "paged": dict(paged=True),
         "int8": dict(paged=True, kv_dtype="int8")}


@pytest.mark.parametrize("mode", list(MODES))
def test_every_adapter_matches_jax_and_merged(mode, cfg, jcfg, params,
                                              jparams, weights):
    """Three adapters through two packed slots (a hot-load and an LRU
    eviction mid-run): every adapter's tokens equal the JAX LoRA engine's
    and the port's merged-weights engine's, and differ from base; base
    tokens equal a LoRA-free engine's."""
    kw = MODES[mode]
    eng = port_engine(cfg, params, **kw)
    jeng = jax_engine(jcfg, jparams, **kw)
    for s in tspecs(weights):
        eng._lora.register(s)
    for s in jspecs(weights):
        jeng._lora.register(s)
    base = run(eng, PROMPT)
    assert base == run(port_engine(cfg, params, slots=0, **kw), PROMPT)
    assert base == run(jeng, PROMPT)
    for s in tspecs(weights):
        got = run(eng, PROMPT, s.name)
        assert got == run(jeng, PROMPT, s.name), s.name
        merged = port_engine(cfg, tlora.merged_params(params, cfg, s),
                             slots=0, **kw)
        assert got == run(merged, PROMPT), s.name
        assert got != base, "the adapter must change the output"
    assert eng._lora.stats == {k: jeng._lora.stats[k]
                               for k in eng._lora.stats}
    assert eng._lora.stats["evictions"] >= 1
    eng._lora.assert_quiescent()
    if kw["paged"]:
        eng._allocator.assert_quiescent()


def test_mixed_batch_and_chunked_prefill(cfg, jcfg, params, jparams,
                                         weights):
    """One batched dispatch serves base and two adapters in neighbouring
    slots; a 48-token prompt prefills through the adapter in chunks. The
    JAX engine's tokens, request by request."""
    outs = []
    for eng, specs in ((port_engine(cfg, params, paged=True),
                        tspecs(weights)),
                       (jax_engine(jcfg, jparams, paged=True),
                        jspecs(weights))):
        for s in specs[:2]:
            eng._lora.register(s)
        reqs = [eng.submit(PROMPT, SamplingParams(max_new_tokens=10)),
                eng.submit(PROMPT, SamplingParams(max_new_tokens=10),
                           adapter="tenant-a"),
                eng.submit(PROMPT, SamplingParams(max_new_tokens=10),
                           adapter="tenant-b")]
        while not all(r.done.is_set() for r in reqs):
            eng.step()
        chunked = run(eng, LONG_PROMPT, "tenant-a", n=8)
        outs.append([r.output_tokens for r in reqs] + [chunked])
        eng._lora.assert_quiescent()
        eng._allocator.assert_quiescent()
    assert outs[0] == outs[1]
    assert outs[0][0] != outs[0][1] != outs[0][2]
    # The chunked prefill applied the adapter: the merged engine agrees.
    merged = port_engine(cfg, tlora.merged_params(
        params, cfg, tspecs(weights)[0]), paged=True, slots=0)
    assert outs[0][3] == run(merged, LONG_PROMPT, n=8)


# -- namespaces: the flat hash, the radix index, the remote tier ---------------------

def test_chain_keys_namespace_matches_jax():
    toks = list(range(32))
    for ns in ("", "tenant-a"):
        assert tpaged.PageAllocator.chain_keys(toks, 16, namespace=ns) == \
            jpaged.PageAllocator.chain_keys(toks, 16, namespace=ns)
    assert tpaged.PageAllocator.chain_keys(toks, 16) != \
        tpaged.PageAllocator.chain_keys(toks, 16, namespace="tenant-a")
    # The flat index never cross-matches namespaces either.
    alloc = tpaged.PageAllocator(8, 16)
    pages = alloc.alloc(2)
    alloc.register_prefix(toks, pages, namespace="tenant-a")
    alloc.free(pages)
    assert alloc.match_prefix(toks + [1], namespace="tenant-b") == []
    assert alloc.match_prefix(toks + [1]) == []
    assert alloc.match_prefix(toks + [1], namespace="tenant-a") == pages


PG = 4
SIG = "L2.H1.D2.P4.full"
TOKS = list(range(100, 112))                 # three pages of 4


class _Dev:
    """Device closures the index calls (page ids as the page bytes)."""

    def __init__(self, jax_side=False):
        self.jax_side = jax_side
        self.uploads = []

    def copy_pages(self, src, dst):
        pass

    def upload_pages(self, ids, k, v):
        self.uploads.append(list(ids))

    def fetch_pages(self, ids):
        k = np.stack([np.full((2, PG, 1, 2), float(p), np.float32)
                      for p in ids], axis=1)
        if self.jax_side:
            return k, k.copy()
        return (torch.from_numpy(k), torch.from_numpy(k.copy())), None


def _index(store, side="port"):
    Index, Alloc = ((tkvtier.RadixPrefixIndex, tpaged.PageAllocator)
                    if side == "port" else
                    (jkvtier.RadixPrefixIndex, jpaged.PageAllocator))
    dev = _Dev(jax_side=side == "jax")
    alloc = Alloc(16, PG, enable_prefix_caching=True)
    idx = Index(alloc, PG, host_pages=8, demote_after_s=0.01,
                scan_interval_s=0.0, remote_after_s=0.0, fabric_sig=SIG,
                copy_pages_fn=dev.copy_pages,
                upload_pages_fn=dev.upload_pages,
                fetch_pages_fn=dev.fetch_pages, remote_store=store)
    return idx, alloc


def _spill(idx, alloc, ns):
    pages = alloc.alloc(len(TOKS) // PG, owner="a")
    idx.insert(TOKS, pages, len(TOKS), namespace=ns)
    alloc.free(list(reversed(pages)))
    idx.tick(now=time.monotonic() + 1)       # device -> host
    idx.drain_migrations()
    idx.tick(now=time.monotonic() + 10)      # host -> remote
    idx.drain_migrations()


@pytest.mark.parametrize("writer,reader", [("port", "jax"), ("jax", "port")])
def test_namespaced_remote_keys_cross_packages(writer, reader, tmp_path):
    """A spill under an adapter's namespace registers the JAX index's key
    strings; the other package adopts it in that namespace only."""
    store_t = ArtifactStore(str(tmp_path))
    store = store_t if writer == "port" else JStore(str(tmp_path))
    widx, walloc = _index(store, writer)
    jidx, _ = _index(None, "jax")
    try:
        _spill(widx, walloc, "tenant-a")
        chain = tuple(tuple(TOKS[i:i + PG]) for i in range(0, len(TOKS), PG))
        want = {jidx._remote_key("tenant-a", chain[:i + 1]) for i in range(3)}
        assert set(store_t.names()) == want
        assert jidx._remote_key("", chain) not in want
    finally:
        widx.close()
        jidx.close()
    ridx, _ = _index(store_t if reader == "port" else JStore(str(tmp_path)),
                     reader)
    try:
        assert ridx.match_and_acquire(TOKS + [1], owner="b",
                                      namespace="tenant-b") == ([], 0)
        hit, covered = ridx.match_and_acquire(TOKS + [1], owner="c",
                                              namespace="tenant-a")
        assert covered == len(TOKS) and len(hit) == 3
        assert ridx.snapshot()["pages_promoted_remote"] == 3
    finally:
        ridx.close()


def test_adapters_never_share_kv(cfg, params, weights):
    """Same prompt under adapter A, adapter B, A again and base on a radix
    engine: only A's re-arrival hits the index, and every output equals
    its merged reference."""
    prompt = list(range(2, 50))
    eng = port_engine(cfg, params, paged=True)
    specs = tspecs(weights)
    for s in specs[:2]:
        eng._lora.register(s)
    order = ["tenant-a", "tenant-b", "tenant-a", None]
    outs = [run(eng, prompt, name, n=8) for name in order]
    tier = eng.kv_tier_stats()
    assert tier["prefix_queries"] == 4
    assert tier["prefix_hits"] == 1, "only tenant-a's re-arrival may match"
    for name, got in zip(order[:2], outs[:2]):
        spec = next(s for s in specs if s.name == name)
        ref = port_engine(cfg, tlora.merged_params(params, cfg, spec),
                          paged=True, slots=0)
        assert got == run(ref, prompt, n=8)
    assert outs[0] == outs[2] and outs[0] != outs[1] != outs[3]
    eng._lora.assert_quiescent()
    eng._allocator.assert_quiescent()


# -- engine lifecycle -----------------------------------------------------------------

def test_submit_unknown_adapter_keyerror(cfg, params):
    eng = port_engine(cfg, params)
    with pytest.raises(KeyError, match="not registered"):
        eng.submit(PROMPT, adapter="nobody")
    bare = port_engine(cfg, params, slots=0)
    with pytest.raises(KeyError, match="serves no adapters"):
        bare.submit(PROMPT, adapter="tenant-a")


def test_slot_backpressure_requeues(cfg, params, weights):
    """Every adapter slot referenced: the next adapter's request waits
    (requeued, not failed) and completes once the slot drains."""
    eng = port_engine(cfg, params, slots=1)
    for s in tspecs(weights)[:2]:
        eng._lora.register(s)
    r1 = eng.submit(PROMPT, SamplingParams(max_new_tokens=6),
                    adapter="tenant-a")
    r2 = eng.submit(PROMPT, SamplingParams(max_new_tokens=6),
                    adapter="tenant-b")
    eng.step()
    assert eng._lora.pending_pressure() and eng._backlog == [r2]
    while not (r1.done.is_set() and r2.done.is_set()):
        eng.step()
    assert r1.finish_reason == r2.finish_reason == "length"
    assert eng._lora.stats["evictions"] == 1
    eng._lora.assert_quiescent()


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_cancel_releases_adapter_ref(paged, cfg, params, weights,
                                     monkeypatch):
    monkeypatch.setenv("KFTPU_SANITIZE", "refcount")
    eng = port_engine(cfg, params, paged=paged)
    eng._lora.register(tspecs(weights)[0])
    req = eng.submit(PROMPT, SamplingParams(max_new_tokens=64),
                     adapter="tenant-a")
    eng.step()                                # admit + start decoding
    assert eng._lora.leak_report_by_owner() == {req.id: 1}
    req.cancel()
    while not req.done.is_set():
        eng.step()
    assert req.finish_reason == "cancelled"
    eng._lora.assert_quiescent()
    if paged:
        eng._allocator.assert_quiescent()


def test_adapter_load_phase_on_trace(cfg, params, weights):
    from kubeflow_tpu_torch.obs.trace import get_tracer, phase_durations

    tracer = get_tracer()
    eng = port_engine(cfg, params, paged=True)
    eng._lora.register(tspecs(weights)[0])
    phases = []
    for name in ("test.request", "test.request2"):
        root = tracer.start_span(name)
        run(eng, PROMPT, "tenant-a", n=4, trace_parent=root)
        root.end("ok")
        phases.append(phase_durations(tracer.trace(root.trace_id)["spans"]))
    assert "adapter_load_ms" in phases[0], phases[0]
    # Resident now: the second request pays no load phase.
    assert "adapter_load_ms" not in phases[1], phases[1]


def test_kv_pressure_folds_adapter_backpressure(cfg, params, weights):
    eng = port_engine(cfg, params, paged=True, slots=1)
    eng._lora.register(tspecs(weights)[0])
    assert eng._kv_pressure() < 1.0
    eng._lora.acquire("tenant-a", owner="r0")
    eng.submit([1, 2, 3])
    eng._drain_waiting()
    assert eng._kv_pressure() >= 1.0
    eng._lora.release("tenant-a")
    assert eng._kv_pressure() < 1.0


@pytest.mark.parametrize("kw", [
    dict(lora=dict(max_adapters=-1)),
    dict(lora=dict(max_adapters=2, rank=0)),
    dict(lora=dict(max_adapters=2, rank=65)),
    dict(lora=dict(max_adapters=2, targets=("wq", "mlp"))),
    dict(lora=dict(max_adapters=2, targets=())),
    dict(role="prefill", lora=dict(max_adapters=2)),
    dict(role="decode", lora=dict(max_adapters=2)),
    dict(speculative=dict(mode="ngram"), lora=dict(max_adapters=2))],
    ids=["negative", "rank0", "rank65", "target", "no-targets", "prefill",
         "decode", "speculative"])
def test_spec_errors_equal_jax(kw):
    with pytest.raises(ValueError) as jexc:
        JBatchingSpec(**kw)
    with pytest.raises(ValueError) as texc:
        BatchingSpec(**kw)
    assert str(texc.value) in str(jexc.value)
    # Off (max_adapters=0) checks nothing else, in both packages.
    assert BatchingSpec(lora=dict(max_adapters=0, rank=0)).lora.rank == 0
    assert JBatchingSpec(lora=dict(max_adapters=0, rank=0)).lora.rank == 0


def test_adapters_refuse_a_handoff(cfg, params, weights):
    eng = port_engine(cfg, params)
    eng._lora.register(tspecs(weights)[0])
    with pytest.raises(ValueError, match="cannot hand off"):
        eng.submit(PROMPT, adapter="tenant-a", handoff=True)


# -- the server and the load generator ---------------------------------------------

@pytest.fixture(scope="module")
def lora_server(cfg, params, weights):
    from kubeflow_tpu_torch.serve.server import ModelServer

    eng = LLMEngine(preset_512(), BatchingSpec(
        max_batch_size=4, max_seq_len=128, prefill_buckets=[32, 128],
        lora=LoRASpec(max_adapters=2, rank=4, targets=ALL_TARGETS)),
        seed=3, device="cpu")
    big = preset_512()
    for name, rank, alpha, targets, seed in ADAPTERS[:2]:
        eng._lora.register(tlora.AdapterSpec(
            name, rank=rank, alpha=alpha,
            weights=_factors(big, rank, targets, seed)))
    srv = ModelServer("base", eng)
    srv.start()
    yield srv
    srv.stop()


def preset_512():
    # vocab 512 covers the byte tokenizer's 259 ids.
    return tconfig.preset("tiny", vocab_size=512, dtype="float32")


def _post(srv, body, headers=None, path="/v1/completions"):
    import http.client
    import json as _json

    conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=60)
    try:
        conn.request("POST", path, body=_json.dumps(body),
                     headers={"Content-Type": "application/json",
                              **(headers or {})})
        resp = conn.getresponse()
        return resp.status, _json.loads(resp.read() or b"{}")
    finally:
        conn.close()


def test_model_field_header_and_404(lora_server):
    import json
    import urllib.request

    prompt = "hello tenants"
    status, obj = _post(lora_server, {"prompt": prompt, "max_tokens": 6})
    assert status == 200
    base_text = obj["choices"][0]["text"]
    status, obj = _post(lora_server, {"prompt": prompt, "max_tokens": 6,
                                      "model": "tenant-a"})
    assert status == 200 and obj["model"] == "tenant-a"
    adapted = obj["choices"][0]["text"]
    assert adapted != base_text
    # The tokens are the engine's under that adapter.
    eng, tok = lora_server.engine, lora_server.tokenizer
    assert obj["usage"]["completion_tokens"] >= 1
    # The header wins over the body field.
    status, obj = _post(lora_server, {"prompt": prompt, "max_tokens": 6,
                                      "model": "tenant-b"},
                        headers={MODEL_HEADER: "tenant-a"})
    assert status == 200 and obj["choices"][0]["text"] == adapted
    # Streamed and v1 predict through the adapter: the same text.
    status, obj = _post(lora_server, {"instances": [prompt], "max_tokens": 6},
                        path="/v1/models/tenant-a:predict")
    assert status == 200 and obj["predictions"] == [adapted]
    # Unknown ids 404: never a silent fall-through to the base weights.
    status, _ = _post(lora_server, {"prompt": prompt, "max_tokens": 6,
                                    "model": "tenant-zzz"})
    assert status == 404
    assert _post(lora_server, {"instances": [prompt]},
                 path="/v1/models/tenant-zzz:predict")[0] == 404
    with urllib.request.urlopen(lora_server.url + "/v1/models",
                                timeout=10) as r:
        assert set(json.loads(r.read())["models"]) == \
            {"base", "tenant-a", "tenant-b"}
    with urllib.request.urlopen(lora_server.url + "/v2/models/tenant-b",
                                timeout=10) as r:
        assert json.loads(r.read())["config"]["vocab_size"] == 512
    text = urllib.request.urlopen(lora_server.url + "/metrics",
                                  timeout=10).read().decode()
    samples = {(n, lab.get("adapter")): v
               for n, lab, v in parse_exposition(text)}
    assert samples[("kftpu_engine_adapters_resident", "tenant-a")] == 1
    assert samples[("kftpu_engine_adapter_loads_total", None)] == 1
    assert tok.decode(eng.generate(tok.encode(prompt), SamplingParams(
        max_new_tokens=6, stop_token=tok.eos_id))) == base_text


def test_multi_adapter_loadgen_reaches_the_adapters(lora_server):
    """``multi_adapter`` through ``ServerTarget``: each request's adapter id
    rides the model field and header, so the server hot-loads them."""
    from kubeflow_tpu_torch import loadgen

    eng = lora_server.engine
    before = eng.adapter_stats()["acquires"]
    sc = next(s for s in loadgen.standard_matrix(
        num_requests=6, rate_rps=20.0, prompt_len=24, max_new=4, seed=0,
        adapter_ids=("tenant-a", "tenant-b"))
        if s.name == "multi_adapter")
    res = loadgen.run_scenario(
        loadgen.ServerTarget(lora_server.url, model="base"), sc,
        vocab_size=eng.cfg.vocab_size, max_prompt_len=64)
    rep = loadgen.build_report(res)
    assert rep["by_status"] == {"ok": 6}, rep["by_status"]
    assert set(rep["adapters"]) <= {"tenant-a", "tenant-b"}
    assert eng.adapter_stats()["acquires"] - before == 6
    eng._lora.assert_quiescent()
