"""Paged KV cache: page pool + page tables + prefix caching — port of
``kubeflow_tpu/serve/paged.py``.

KV lives in a pool of pages ``[L, P + 1, page, KV, Dh]``; each slot owns an
ordered page list (its page table), and:

- **Allocation** is a host-side free list with O(1) alloc/free between
  device steps; the device only ever sees page-id tensors.
- **Prefix caching**: pages holding FULL prompt prefixes are content-hashed
  (chained: page i's key folds page i-1's key), refcounted, and reused
  across requests. Freed pages linger in the hash map (ref=0, LRU) until
  the pool needs them. The radix index (``serve/kvtier.py``) extends this
  with live copy-on-write sharing through ``retained`` / ``on_evict``.
- **Preemption = recompute**: if the pool cannot cover a running slot's
  next tokens even after evicting cached pages, the youngest slot releases
  its pages and its request requeues with prompt + generated so far.

Device side, the paged steps mirror the engine's contiguous ones: the page
table rides into a dispatch as a ``[B, max_pages_per_slot]`` int32 tensor;
reads either gather pages back into the ``[B, S, KV, Dh]`` layout ("gather")
or go straight through the paged-decode kernel ("pallas",
``ops/paged_attention.py``); writes scatter ``(page, offset)``.

**The sink page.** The JAX package aims dead writes (dead rows, unmapped
pages, padding) out of bounds and lets the scatter drop them. Torch has no
dropping scatter, so the pool carries one extra page, the last index
``P``: it is never allocated and never in a table, and every write that
JAX would drop lands there instead (decode writes, chunk writes,
``copy_pages`` padding). Several dead rows may hit the same sink cell in
one scatter, which is harmless because nothing ever reads the sink: the
kernel and the gather only follow table entries, which are real pages or
-1. Pools are updated in place (the JAX functions return new arrays).

Exactness: with "gather" the same ops run over the same values as the
contiguous engine; "pallas" is exact blockwise softmax with fp32
accumulation (its probabilities are never rounded to the cache dtype), so
it is numerically equal, not bitwise.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Optional, Sequence

import numpy as np
import torch

from kubeflow_tpu_torch.models import layers as L
from kubeflow_tpu_torch.models.config import DecoderConfig
from kubeflow_tpu_torch.models.decoder import (
    Params, decoder_forward, layer_view, lm_head,
)
from kubeflow_tpu_torch.ops.paged_attention import paged_decode_attention
from kubeflow_tpu_torch.ops.quantization import dequantize_kv, quantize_kv
from kubeflow_tpu_torch.runtime.sanitize import call_site, enabled


# -- host-side page allocator --------------------------------------------------

class PagePoolExhausted(Exception):
    pass


class PageAllocator:
    """Free-list page allocator with chained-hash prefix caching.

    Pages are ints in [0, num_pages). A page is in exactly one of:
    - allocated (ref > 0): owned by one or more slots;
    - cached (ref == 0, still hash-mapped or radix-retained): reusable
      prefix content, evicted LRU when the free list runs dry;
    - free: on the free list.
    """

    def __init__(self, num_pages: int, page_size: int,
                 enable_prefix_caching: bool = True):
        self.num_pages = num_pages
        self.page_size = page_size
        self.prefix_caching = enable_prefix_caching
        self._free: list[int] = list(range(num_pages - 1, -1, -1))
        self._ref = np.zeros((num_pages,), np.int32)
        # content key -> page id (for reuse); page id -> key (for eviction)
        self._by_key: dict[tuple, int] = {}
        self._key_of: dict[int, tuple] = {}
        # ref==0 pages that still hold cached content, LRU order
        self._reclaimable: "OrderedDict[int, None]" = OrderedDict()
        # Radix-index integration (serve/kvtier.py): pages the index wants
        # kept reclaimable at ref==0 without a flat-hash key, and the
        # callback the LRU eviction path fires so the index can drop the
        # node (and cascade its now-unreachable subtree).
        self.retained: set[int] = set()
        self.on_evict = None
        self.stats = {"prefix_hits": 0, "prefix_queries": 0, "evictions": 0,
                      "stamped_allocs": 0}
        # KFTPU_SANITIZE=refcount: stamp every alloc/incref with owner +
        # call site so assert_quiescent can say WHO leaked. One stamp per
        # outstanding reference, popped LIFO by free().
        self.refcount_debug = enabled("refcount")
        self._stamps: dict[int, list[str]] = {}

    # -- refcount sanitizer ------------------------------------------------

    def _stamp(self, page: int, owner: Optional[str]) -> None:
        label = owner if owner is not None else call_site((__file__,))
        self._stamps.setdefault(page, []).append(label)
        self.stats["stamped_allocs"] += 1

    def _unstamp(self, page: int) -> None:
        stamps = self._stamps.get(page)
        if stamps:
            stamps.pop()
            if not stamps:
                del self._stamps[page]

    def leak_report_by_owner(self) -> dict:
        """owner label -> page references it still holds (refcount mode
        only; {} when quiescent)."""
        out: dict[str, int] = {}
        for page in np.flatnonzero(self._ref > 0):
            for label in self._stamps.get(int(page), ()) or ["<unstamped>"]:
                out[label] = out.get(label, 0) + 1
        return out

    # -- raw pages ---------------------------------------------------------

    def available(self) -> int:
        return len(self._free) + len(self._reclaimable)

    def cached(self) -> int:
        """Pages holding reusable prefix content at ref==0 — freely
        evictable, so not load."""
        return len(self._reclaimable)

    def ref(self, page: int) -> int:
        return int(self._ref[page])

    def reclaimable_lru(self) -> list[int]:
        """Ref-0 cached pages, least-recently-released first."""
        return list(self._reclaimable)

    def drop_cached(self, pages: Sequence[int]) -> None:
        """Discard ref-0 cached pages outright (content no longer reachable,
        e.g. an evicted radix subtree): straight to the free list."""
        for p in pages:
            assert self._ref[p] == 0, f"drop_cached of referenced page {p}"
            key = self._key_of.pop(p, None)
            if key is not None:
                self._by_key.pop(key, None)
            self.retained.discard(p)
            if p in self._reclaimable:       # values are None: test by key
                del self._reclaimable[p]
                self._free.append(p)

    def in_use(self) -> int:
        """Pages currently referenced by at least one slot (0 once every
        request has finished or been reaped)."""
        return int((self._ref > 0).sum())

    def leak_report(self) -> dict:
        """Pages still referenced and their refcounts ({} when quiescent)."""
        held = np.flatnonzero(self._ref > 0)
        return {int(p): int(self._ref[p]) for p in held}

    def assert_quiescent(self) -> None:
        """Every alloc/incref balanced by exactly one free: no page may stay
        referenced once all requests are done. Under
        ``KFTPU_SANITIZE=refcount`` the failure names the owners."""
        leaked = self.leak_report()
        if leaked:
            msg = (f"KV page leak: {len(leaked)} page(s) still referenced "
                   f"(page -> ref): {dict(list(leaked.items())[:16])}")
            if self.refcount_debug:
                by_owner = self.leak_report_by_owner()
                msg += ("; outstanding references by owner: "
                        + ", ".join(f"{o}={n}" for o, n in
                                    sorted(by_owner.items())))
            raise AssertionError(msg)

    def alloc(self, n: int, owner: Optional[str] = None) -> list[int]:
        """n fresh pages (ref=1 each). Evicts cached pages LRU if needed."""
        if self.available() < n:
            raise PagePoolExhausted(f"need {n}, have {self.available()}")
        out = []
        for _ in range(n):
            if self._free:
                p = self._free.pop()
            else:
                p, _ = self._reclaimable.popitem(last=False)   # LRU evict
                key = self._key_of.pop(p, None)
                if key is not None:
                    self._by_key.pop(key, None)
                if p in self.retained:
                    self.retained.discard(p)
                    if self.on_evict is not None:
                        # The radix index drops the node; its subtree's
                        # cached pages cascade to the free list via
                        # drop_cached, which this loop then consumes.
                        self.on_evict(p)
                self.stats["evictions"] += 1
            self._ref[p] = 1
            if self.refcount_debug:
                self._stamps.pop(p, None)   # fresh ownership history
                self._stamp(p, owner)
            out.append(p)
        return out

    def incref(self, pages: Sequence[int],
               owner: Optional[str] = None) -> None:
        for p in pages:
            if self._ref[p] == 0:
                self._reclaimable.pop(p, None)
            self._ref[p] += 1
            if self.refcount_debug:
                self._stamp(p, owner)

    def free(self, pages: Sequence[int]) -> None:
        """Drop one reference; ref-0 pages become reclaimable (cached) if
        indexed, else go straight to the free list."""
        for p in pages:
            self._ref[p] -= 1
            assert self._ref[p] >= 0, f"double free of page {p}"
            if self.refcount_debug:
                self._unstamp(p)
            if self._ref[p] == 0:
                if p in self._key_of or p in self.retained:
                    self._reclaimable[p] = None    # keep content, LRU
                else:
                    self._free.append(p)

    # -- prefix caching ----------------------------------------------------

    @staticmethod
    def chain_keys(tokens: Sequence[int], page_size: int) -> list[tuple]:
        """Chained content keys for every FULL page of ``tokens``."""
        keys, parent = [], ()
        for i in range(len(tokens) // page_size):
            parent = (hash((parent, tuple(
                tokens[i * page_size:(i + 1) * page_size]))),)
            keys.append(parent)
        return keys

    def match_prefix(self, tokens: Sequence[int],
                     owner: Optional[str] = None) -> list[int]:
        """Longest run of cached pages for ``tokens``' full-page prefix
        (capped so at least one prompt token remains to prefill — the first
        sampled token needs real last-token logits). Bumps refs on the hit
        pages; the caller owns them."""
        if not self.prefix_caching:
            return []
        self.stats["prefix_queries"] += 1
        max_reuse = (len(tokens) - 1) // self.page_size
        hit: list[int] = []
        for key in self.chain_keys(tokens, self.page_size)[:max_reuse]:
            page = self._by_key.get(key)
            if page is None:
                break
            hit.append(page)
        if hit:
            self.incref(hit, owner=owner)
            self.stats["prefix_hits"] += 1
        return hit

    def register_prefix(self, tokens: Sequence[int],
                        pages: Sequence[int]) -> None:
        """Hash ``pages`` as holding ``tokens``' full-page prefixes (called
        after the KV is actually written)."""
        if not self.prefix_caching:
            return
        for key, page in zip(self.chain_keys(tokens, self.page_size),
                             pages):
            old = self._by_key.get(key)
            if old is not None and old != page:
                continue     # first writer wins; duplicates just aren't hashed
            self._by_key[key] = page
            self._key_of[page] = key


# -- device-side paged steps ---------------------------------------------------
#
# Cache dict: {"k": [L, P+1, pg, KV, Dh], "v": same, "table": [B, mpp] int32,
# and for int8 pools "ks"/"vs": [L, P+1, pg, KV] f32}, mpp = max_seq_len //
# page. Index P is the sink page; table entries are real page ids or -1.


def paged_gather(pool: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """[P,pg,...] pool + [B,mpp] table -> [B, mpp*pg, ...] per-slot view
    (-1 entries read page 0; the length mask never lets them count)."""
    b, mpp = table.shape
    pages = pool[table.long().clamp(0, pool.shape[0] - 1)]   # [B,mpp,pg,...]
    return pages.reshape(b, mpp * pool.shape[1], *pool.shape[2:])


def _write_index(table: torch.Tensor, lengths: torch.Tensor,
                 live: torch.Tensor, page_size: int, sink: int):
    """(page, offset) of each row's decode write: dead rows and unmapped
    pages aim at the sink page."""
    bidx = torch.arange(table.shape[0], device=table.device)
    page_slot = (lengths // page_size).clamp(0, table.shape[1] - 1)
    page_id = table[bidx, page_slot].long()
    ok = live & (page_id >= 0)
    return torch.where(ok, page_id, sink), lengths % page_size


def _paged_decode_block(bp, x, positions, lengths, live, pool_k, pool_v,
                        table, cfg: DecoderConfig, attn_impl: str = "gather",
                        pool_ks=None, pool_vs=None):
    """One transformer block for a [B,1] decode step against one layer's
    page pool (written in place). Mirrors the engine's ``_decode_block``;
    only the KV residency differs.

    ``attn_impl``: "gather" materialises the slots' pages into the
    contiguous layout and runs the engine's decode attention; "pallas"
    reads pages directly through ``paged_decode_attention`` (the kernel on
    CUDA tensors). ``pool_ks``/``pool_vs`` ([P+1,pg,KV] f32, present iff
    the pool stores int8): writes quantize; "gather" dequantizes into the
    attention's operand, the kernel dequantizes in registers."""
    from kubeflow_tpu_torch.serve.engine import _decode_attention

    dt = cfg.activation_dtype
    h = L.rmsnorm(x, bp["ln1"], cfg)
    q = L.project(h, bp["attn"]["wq"], dt)
    k = L.project(h, bp["attn"]["wk"], dt)
    v = L.project(h, bp["attn"]["wv"], dt)
    q = L.rope(q, positions, cfg.rope_theta)
    k = L.rope(k, positions, cfg.rope_theta)
    pidx, off = _write_index(table, lengths, live, pool_k.shape[1],
                             pool_k.shape[0] - 1)
    if pool_ks is not None:
        kq, ks = quantize_kv(k[:, 0])
        vq, vs = quantize_kv(v[:, 0])
        pool_k[pidx, off] = kq
        pool_v[pidx, off] = vq
        pool_ks[pidx, off] = ks
        pool_vs[pidx, off] = vs
        if attn_impl == "pallas":
            attn = paged_decode_attention(q, pool_k, pool_v, table, lengths,
                                          pool_ks=pool_ks, pool_vs=pool_vs)
        else:
            ck = dequantize_kv(paged_gather(pool_k, table),
                               paged_gather(pool_ks, table), dt)
            cv = dequantize_kv(paged_gather(pool_v, table),
                               paged_gather(pool_vs, table), dt)
            attn = _decode_attention(q, ck, cv, lengths, cfg)
    else:
        pool_k[pidx, off] = k[:, 0]
        pool_v[pidx, off] = v[:, 0]
        if attn_impl == "pallas":
            attn = paged_decode_attention(q, pool_k, pool_v, table, lengths)
        else:
            attn = _decode_attention(q, paged_gather(pool_k, table),
                                     paged_gather(pool_v, table), lengths,
                                     cfg)
    x = x + L.out_project(attn, bp["attn"]["wo"], dt)
    h = L.rmsnorm(x, bp["ln2"], cfg)
    return x + L.mlp_block(bp["mlp"], h, cfg)


def _paged_decode_step(params: Params, cache: dict, tokens: torch.Tensor,
                       lengths: torch.Tensor, live: torch.Tensor,
                       cfg: DecoderConfig, attn_impl: str = "gather"
                       ) -> torch.Tensor:
    """One [B,1] decode step over the page pool (≈ the engine's
    ``_decode_step``). Returns logits [B,V] fp32; the pools are written in
    place."""
    dt = cfg.activation_dtype
    quant = "ks" in cache
    x = params["embed"][tokens[:, None]].to(dt)
    if cfg.embed_scale:
        x = x * L.embed_scale_value(cfg)
    positions = lengths[:, None]
    table = cache["table"]
    for i in range(cfg.n_layers):
        x = _paged_decode_block(
            layer_view(params["layers"], i), x, positions, lengths, live,
            cache["k"][i], cache["v"][i], table, cfg, attn_impl=attn_impl,
            pool_ks=cache["ks"][i] if quant else None,
            pool_vs=cache["vs"][i] if quant else None)
    x = L.rmsnorm(x, params["final_norm"], cfg)
    return lm_head(params, x, cfg)[:, 0]


def paged_decode_multi(params: Params, cache: dict, tokens: torch.Tensor,
                       lengths: torch.Tensor, live: torch.Tensor,
                       temps: torch.Tensor, top_k: torch.Tensor,
                       top_p: torch.Tensor, stop_tokens: torch.Tensor,
                       budgets: torch.Tensor, gen: torch.Generator,
                       cfg: DecoderConfig, num_steps: int,
                       sample_mode: str = "full", attn_impl: str = "gather"):
    """``num_steps`` decode+sample steps over the page pool with no host
    synchronisation (≈ the engine's ``_decode_multi``: every step runs,
    finished rows are masked — their writes land on the sink page). The
    host pre-allocates pages covering ``lengths + num_steps`` plus the
    rounds in flight, so mid-dispatch page crossings land on mapped pages.
    Returns (out, tokens, lengths, live, budgets)."""
    from kubeflow_tpu_torch.serve.engine import _sample_batch

    b = tokens.shape[0]
    max_len = cache["table"].shape[1] * cache["k"].shape[2]
    out = torch.full((b, num_steps), -1, dtype=torch.int64,
                     device=tokens.device)
    for i in range(num_steps):
        logits = _paged_decode_step(params, cache, tokens, lengths, live, cfg,
                                    attn_impl=attn_impl)
        sampled = _sample_batch(logits, gen, temps, top_k, top_p,
                                mode=sample_mode)
        tokens = torch.where(live, sampled, tokens)
        out[:, i] = torch.where(live, sampled, torch.full_like(sampled, -1))
        lengths = torch.where(live, lengths + 1, lengths)
        budgets = torch.where(live, budgets - 1, budgets)
        live = live & (sampled != stop_tokens) & (budgets > 0) \
            & (lengths + 1 < max_len)
    return out, tokens, lengths, live, budgets


def copy_pages(cache: dict, src: torch.Tensor, dst: torch.Tensor) -> dict:
    """Page-to-page pool copy ``dst[i] <- src[i]`` for every pool plane
    (k/v and, when quantized, their scales), in place — the radix index's
    copy-on-write primitive. ``dst`` ids outside the real pages (-1
    padding) land on the sink page."""
    for name in ("k", "v", "ks", "vs"):
        pool = cache.get(name)
        if pool is None:
            continue
        sink = pool.shape[1] - 1
        d = torch.where((dst >= 0) & (dst < sink), dst, sink).long()
        pool[:, d] = pool[:, src.long().clamp(0, sink - 1)]
    return cache


def context_bucket(pos: int, chunk: int, page_size: int, mpp: int) -> int:
    """Context-page bucket for a chunk prefill at ``pos``: the next power
    of two covering ceil((pos + chunk) / page_size), clamped to the slot's
    table length (the JAX engine's static trace bucket; here it bounds the
    gather to the pages the chunk can see)."""
    need = -(-(pos + chunk) // page_size)
    ctx = 1
    while ctx < need:
        ctx *= 2
    return min(ctx, mpp)


def paged_chunk_prefill(params: Params, cache: dict, tokens: torch.Tensor,
                        table_row: torch.Tensor, start: int, valid_len: int,
                        cfg: DecoderConfig, attn_impl: str = "xla",
                        context_pages: Optional[int] = None):
    """Prefill ONE chunk (``tokens`` [1,C], positions [start, start+C)) of a
    slot whose pages are ``table_row`` [mpp]. The chunk attends to the
    slot's earlier KV by gathering the (bucketed) table row into the
    contiguous layout ``decoder_forward``'s cache path expects, padded by
    one chunk of scratch so the C-wide write window never clamps; then only
    the chunk's first ``valid_len`` tokens scatter back per (page, offset),
    so ``start`` needs no page alignment (the radix COW tail resumes
    mid-page). Padding and unmapped pages aim at the sink page. Returns
    [C, V] logits; the pools are written in place."""
    pg = cache["k"].shape[2]
    c = tokens.shape[1]
    sink = cache["k"].shape[1] - 1
    quant = "ks" in cache
    if context_pages is not None:
        table_row = table_row[:min(context_pages, table_row.shape[0])]
    ctx = table_row.shape[0]
    idx = table_row.long().clamp(0, sink - 1)
    row_k, row_v = cache["k"][:, idx], cache["v"][:, idx]   # [L,ctx,pg,K,D]
    if quant:
        dt = cfg.activation_dtype
        row_k = dequantize_kv(row_k, cache["ks"][:, idx], dt)
        row_v = dequantize_kv(row_v, cache["vs"][:, idx], dt)
    nl, kh, d = row_k.shape[0], row_k.shape[3], row_k.shape[4]
    pad = torch.zeros((nl, 1, c, kh, d), dtype=row_k.dtype,
                      device=row_k.device)
    row_k = torch.cat([row_k.reshape(nl, 1, ctx * pg, kh, d), pad], dim=2)
    row_v = torch.cat([row_v.reshape(nl, 1, ctx * pg, kh, d), pad], dim=2)
    caches = {"k": row_k, "v": row_v, "len": start}
    logits, _ = decoder_forward(params, tokens, cfg, kv_caches=caches,
                                attn_impl=attn_impl)
    written_k = row_k[:, 0, start:start + c]                 # [L,C,K,D]
    written_v = row_v[:, 0, start:start + c]
    i = torch.arange(c, device=tokens.device)
    pos = start + i
    pslot = pos // pg
    page_id = table_row[pslot.clamp(0, ctx - 1)].long()
    ok = (i < valid_len) & (page_id >= 0) & (pslot < ctx) & (page_id < sink)
    pidx = torch.where(ok, page_id, sink)
    off = pos % pg
    if quant:
        written_k, wks = quantize_kv(written_k)
        written_v, wvs = quantize_kv(written_v)
        cache["ks"][:, pidx, off] = wks
        cache["vs"][:, pidx, off] = wvs
    cache["k"][:, pidx, off] = written_k
    cache["v"][:, pidx, off] = written_v
    return logits[0]
