"""Radix prefix index with copy-on-write page sharing over the paged pool —
the device tier of ``kubeflow_tpu/serve/kvtier.py``.

**Radix prefix index.** One tree over the page pool; a node is one
page-sized token block (partial leaves hold the sub-page tail of a
registered sequence). ``match_and_acquire`` walks the query and returns the
longest shared path — WHILE the original owner is still decoding (live
sharing: node pages carry one allocator reference per sharer, so
``KFTPU_SANITIZE=refcount`` attributes every reference to its request and
``assert_quiescent`` stays exact per owner). Divergence inside a block is
copy-on-write: the new request gets a fresh page and ONE device copy of the
shared partial tail (``serve/paged.copy_pages``), and its prefill resumes
mid-page (``paged_chunk_prefill`` scatters per token). Shared pages are
never written: decode and chunk writes land past the claimed content, and
the partial tail is private after the copy. Registration happens at
prefill completion (live), at slot release (prompt + generated tokens), at
reap, and at chunking preemption.

**Ownership model** (extends the allocator's): the tree holds NO
references. A node page's refcount is exactly its sharer count; at ref==0
the page parks on the allocator's reclaimable LRU (``retained`` keeps it
there without a flat-hash key), still indexed and matchable. Pool pressure
evicts reclaimable pages LRU; the ``on_evict`` callback drops the node and
cascades its now-unreachable subtree back to the free list (a descendant of
a ref-0 page is ref-0 itself: any sharer of a deep node holds references to
every ancestor on its path). An allocation inside a match can fire that
callback back into the index (the COW tail's alloc may evict the very node
it wanted to copy), so every step after an alloc re-checks the node.

The host-RAM and remote-store tiers (demotion, promotion, the migration
thread) are a later slice: this index keeps everything on the device and
starts no thread. Like the allocator it extends, it is scheduler-confined:
the engine calls it from its scheduler thread only.
"""

from __future__ import annotations

import logging
import time
from typing import Callable, Optional, Sequence

logger = logging.getLogger("kubeflow_tpu_torch.serve.kvtier")

TIER_DEVICE = "device"
TIER_DEAD = "dead"             # evicted; structure detached

#: Partial (sub-page) leaves kept per parent.
MAX_PARTIALS = 4


class _Node:
    """One page-sized token block. ``block`` is the claimed content
    (len == page_size for full blocks; shorter for partial leaves —
    positions past ``len(block)`` in the page are unclaimed)."""

    __slots__ = ("block", "page", "tier", "children", "partials", "parent",
                 "last_used")

    def __init__(self, block: tuple, page: Optional[int], parent):
        self.block = block
        self.page = page
        self.tier = TIER_DEVICE
        self.children: dict = {}     # full-block tuple -> _Node
        self.partials: list = []     # sub-page leaves
        self.parent = parent
        self.last_used = time.monotonic()

    def full(self, page_size: int) -> bool:
        return len(self.block) == page_size


def _lcp(a: Sequence[int], b: Sequence[int]) -> int:
    n = min(len(a), len(b))
    i = 0
    while i < n and a[i] == b[i]:
        i += 1
    return i


class RadixPrefixIndex:
    """Radix tree over one ``PageAllocator`` (device tier).

    ``copy_pages_fn(src_ids, dst_ids)`` is the engine's pool page copy
    (COW tails); it enqueues on the device stream in program order with the
    chunk prefill that reads the copy. ``pressure_fn`` returns the
    pool-pressure ratio exported as ``kv_tier_pressure`` (>= 1.0 = urgent);
    None keeps the default rule (free + cached pages down to a quarter of
    the pool)."""

    def __init__(self, allocator, page_size: int, *,
                 copy_pages_fn: Optional[Callable] = None,
                 pressure_fn: Optional[Callable[[], float]] = None):
        self._allocator = allocator
        self.page_size = int(page_size)
        self._copy_pages = copy_pages_fn
        self._pressure_fn = pressure_fn
        self._root = _Node((), None, None)
        self._by_page: dict[int, _Node] = {}
        self.stats = {
            "prefix_queries": 0, "prefix_hits": 0,
            "tokens_matched": 0, "tokens_cow": 0,
            "cow_copies": 0, "nodes": 0, "evictions": 0,
        }
        self.last_cow_tokens = 0
        allocator.on_evict = self._on_evict

    # -- observability -------------------------------------------------------

    def pressure(self) -> float:
        """Current pool-pressure ratio (>= 1.0 = urgent)."""
        if self._pressure_fn is not None:
            return float(self._pressure_fn())
        quarter = self._allocator.num_pages // 4
        return quarter / max(self._allocator.available(), 1)

    def snapshot(self) -> dict:
        return dict(self.stats)

    # -- match (admission path) ----------------------------------------------

    def match_and_acquire(self, tokens: Sequence[int],
                          owner: Optional[str] = None, *,
                          allow_cow: bool = True) -> tuple[list[int], int]:
        """Longest shared prefix of ``tokens``, capped one token short (the
        first sampled token needs real last-token logits). Returns
        ``(pages, covered_tokens)``: device pages the caller now owns one
        reference to each, in table order. Full-block hits share by incref
        (live, ref>0); a sub-page divergence allocates a fresh private page
        and device-copies the shared tail (``allow_cow=False`` keeps the
        match page-aligned). Pool exhaustion truncates the match rather
        than failing the admission; any failure misses cleanly (the prefix
        is recomputed)."""
        pg = self.page_size
        cap = len(tokens) - 1
        pages: list[int] = []
        self.last_cow_tokens = 0
        try:
            return self._match(tokens, owner, allow_cow, pg, cap, pages)
        except Exception as exc:
            # Balance the books and miss: every acquired page holds exactly
            # one of our references.
            if pages:
                self._allocator.free(pages)
            logger.error("radix match failed; recomputing prefix: %s", exc)
            return [], 0

    def _match(self, tokens, owner, allow_cow, pg, cap,
               pages) -> tuple[list[int], int]:
        self.stats["prefix_queries"] += 1
        # Mirror into the allocator's counters: one hit/query surface
        # whichever index is active.
        self._allocator.stats["prefix_queries"] += 1
        now = time.monotonic()
        covered = 0
        node = self._root
        while covered + pg <= cap:
            child = node.children.get(tuple(tokens[covered:covered + pg]))
            if child is None or child.tier == TIER_DEAD:
                break
            # Device hit (possibly still owned by a decoding request): one
            # more sharer, stamped per owner.
            self._allocator.incref([child.page], owner=owner)
            child.last_used = now
            pages.append(child.page)
            covered += pg
            node = child
        # Sub-page tail: the query continues into (or diverges inside) a
        # cached block — copy only the shared part.
        rem = cap - covered
        if allow_cow and rem > 0 and self._copy_pages is not None:
            window = tuple(tokens[covered:covered + pg])
            best, best_len = None, 0
            for cand in list(node.children.values()) + node.partials:
                if cand.tier == TIER_DEAD:
                    continue
                n = min(_lcp(cand.block, window), rem)
                if n > best_len:
                    best, best_len = cand, n
            if best is not None and best_len > 0:
                cow = self._cow_tail(best, owner)
                if cow is not None:
                    pages.append(cow)
                    covered += best_len
                    best.last_used = now
                    self.stats["tokens_cow"] += best_len
                    self.last_cow_tokens = best_len
        if covered:
            self.stats["prefix_hits"] += 1
            self._allocator.stats["prefix_hits"] += 1
            self.stats["tokens_matched"] += covered
        return pages, covered

    def _cow_tail(self, src: _Node, owner) -> Optional[int]:
        """Fresh private page holding ``src``'s claimed content (a device
        copy). Returns the page id, or None when the pool is dry or the
        source was evicted by this very allocation."""
        from kubeflow_tpu_torch.serve.paged import PagePoolExhausted

        if src.tier != TIER_DEVICE:
            return None
        try:
            fresh = self._allocator.alloc(1, owner=owner)[0]
        except PagePoolExhausted:
            return None
        if src.tier != TIER_DEVICE:
            # The alloc reclaims ref-0 indexed pages through the eviction
            # callback — under pool pressure the coldest cached page is
            # often ``src`` itself, which arrives here DEAD. Nothing left
            # to copy.
            self._allocator.free([fresh])
            return None
        try:
            self._copy_pages([src.page], [fresh])
        except Exception:
            # The fresh ref must not strand on a failed device call.
            self._allocator.free([fresh])
            raise
        self.stats["cow_copies"] += 1
        return fresh

    # -- registration --------------------------------------------------------

    def insert(self, tokens: Sequence[int], pages: Sequence[int],
               n_tokens: Optional[int] = None) -> None:
        """Index ``tokens[:n_tokens]``'s KV: full blocks become (or confirm)
        tree nodes pointing at the registering slot's pages, a sub-page
        remainder becomes (or extends) a partial leaf. Existing nodes keep
        their page (first writer wins — the duplicate page stays slot-owned
        and frees at release). Pages referenced here may still be LIVE (the
        owner keeps decoding past the claimed content)."""
        pg = self.page_size
        n_tokens = len(tokens) if n_tokens is None else min(n_tokens,
                                                            len(tokens))
        now = time.monotonic()
        node = self._root
        nfull = n_tokens // pg
        for i in range(min(nfull, len(pages))):
            blk = tuple(tokens[i * pg:(i + 1) * pg])
            child = node.children.get(blk)
            if child is None:
                page = pages[i]
                if page in self._by_page:
                    break      # already indexed on another path
                child = _Node(blk, page, node)
                node.children[blk] = child
                self._by_page[page] = child
                self._allocator.retained.add(page)
                self.stats["nodes"] += 1
                # A full block subsumes any partial leaf it extends.
                for pn in list(node.partials):
                    if blk[:len(pn.block)] == pn.block:
                        self._drop_subtree(pn)
            elif child.tier == TIER_DEAD:
                break
            child.last_used = now
            node = child
        tail = tuple(tokens[nfull * pg:n_tokens])
        if tail and nfull < len(pages):
            self._insert_partial(node, tail, pages[nfull], now)

    def _insert_partial(self, parent: _Node, tail: tuple, page: int,
                        now: float) -> None:
        if any(blk[:len(tail)] == tail for blk in parent.children):
            return                       # a full block already covers it
        for pn in parent.partials:
            if pn.page == page:
                # Same page re-registered with more content (a finished
                # request upgrading its prompt tail with generated tokens):
                # extend the claim in place.
                if len(tail) > len(pn.block) \
                        and tail[:len(pn.block)] == pn.block:
                    pn.block = tail
                pn.last_used = now
                return
            if len(tail) <= len(pn.block) \
                    and pn.block[:len(tail)] == tail:
                pn.last_used = now
                return                   # existing partial covers more
        if page in self._by_page:
            return
        # Longer content on a different page replaces the covered leaf.
        for pn in list(parent.partials):
            if len(pn.block) < len(tail) \
                    and tail[:len(pn.block)] == pn.block:
                self._drop_subtree(pn)
        if len(parent.partials) >= MAX_PARTIALS:
            self._drop_subtree(min(parent.partials,
                                   key=lambda n: n.last_used))
        leaf = _Node(tail, page, parent)
        parent.partials.append(leaf)
        self._by_page[page] = leaf
        self._allocator.retained.add(page)
        self.stats["nodes"] += 1

    # -- eviction (allocator callback) ---------------------------------------

    def _on_evict(self, page: int) -> None:
        """The allocator reclaimed a ref-0 indexed page for a fresh alloc:
        drop the node; its subtree is unreachable now and cascades back to
        the free list."""
        node = self._by_page.pop(page, None)
        if node is None:
            return
        self.stats["evictions"] += 1
        node.page = None             # the allocator owns it again
        self._drop_subtree(node)

    def _drop_subtree(self, node: _Node) -> None:
        parent = node.parent
        if parent is not None:
            parent.children.pop(node.block, None)
            if node in parent.partials:
                parent.partials.remove(node)
        stack, drop_pages = [node], []
        while stack:
            n = stack.pop()
            stack.extend(n.children.values())
            stack.extend(n.partials)
            if n.tier == TIER_DEVICE and n.page is not None:
                self._by_page.pop(n.page, None)
                if self._allocator.ref(n.page) == 0:
                    drop_pages.append(n.page)
                else:
                    # Still shared by a live request: the sharer keeps its
                    # reference; the page just stops being indexed.
                    self._allocator.retained.discard(n.page)
            n.tier = TIER_DEAD
            n.page = None
            n.children = {}
            n.partials = []
            self.stats["nodes"] -= 1
        if drop_pages:
            self._allocator.drop_cached(drop_pages)
