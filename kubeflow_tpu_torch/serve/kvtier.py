"""Tiered KV cache: a radix prefix index with copy-on-write page sharing
over the paged pool, a host-RAM overflow tier with asynchronous
device↔host page migration, and a remote third tier in the artifact store
that any replica of the same model shape can adopt from — the port of
``kubeflow_tpu/serve/kvtier.py``.

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
reap, at chunking preemption and at handoff adoption.

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

**Host-RAM tier** (``host_pages > 0``). Cold prefix pages — sharer-free
device pages idle past ``demote_after_s`` — migrate device→host in batches.
The scheduler enqueues ONE device-side gather per batch into new tensors
(``fetch_pages_fn``): stream order makes the gather read the pages before
any later kernel can reuse them, so the pages free at once. The gather's
copy into pinned host memory waits on the gather's event and runs on a
side stream; the background migration thread waits on the copy's event
(never on the whole device) and encodes each page with
``serve/handoff.pages_to_wire`` — the handoff's byte layout — so the
scheduler never blocks on a demotion. A radix hit on a host node promotes
it BEFORE prefill admits: the blob decodes zero-copy, fresh device pages
are allocated, and one batched upload (``upload_pages_fn``) is enqueued on
the scheduler's stream ahead of the chunk prefill, so stream order makes
the prefill read the promoted content.

**Remote third tier** (``remote_store``, the fleet property). Host blobs
idle past ``remote_after_s`` spill into the artifact store
(``pipelines/artifacts.py``, content-addressed, so a blob's digest is its
checksum): the migration thread publishes the already-encoded wire blob
and registers it under a name derived from ``(fabric signature,
namespace, block chain)`` (``_remote_key``, the JAX index's key string for
string), so ANY replica of the same cache geometry — a port or a JAX one —
finds it by walking its own radix miss, and a conversation's KV survives
its engine. A walk that runs out of in-memory nodes probes the registry
for the next block; all remote work of one match shares one deadline
(``remote_deadline_s``): a slow or unreachable store degrades to a shorter
match (the tail is recomputed), counted in ``remote_promote_timeouts``,
and never wedges admission. Fetched bytes are re-verified against the
content address before a page is allocated — a truncated or corrupt blob
is a miss plus ``remote_blobs_corrupt``. Crash ordering is
publish → register → install: a SIGKILL mid-spill leaves at worst an
unregistered blob for the store's GC sweep.

The tree and every public method are scheduler-confined — the engine
calls them from its scheduler thread only, like the allocator. The one
cross-thread seam is the migration thread installing host blobs; ``_lock``
guards the tier/blob/host-count transitions it shares with the scheduler.
"""

from __future__ import annotations

import hashlib
import logging
import queue
import threading
import time
from typing import Callable, Optional, Sequence

from kubeflow_tpu_torch.obs.trace import get_tracer
from kubeflow_tpu_torch.serve.handoff import (
    host_array, pages_from_wire, pages_to_wire,
)
from kubeflow_tpu_torch.serve.retry import (
    STORE_POLICY, call_with_retry, env_float,
)

logger = logging.getLogger("kubeflow_tpu_torch.serve.kvtier")

TIER_DEVICE = "device"
TIER_HOST = "host"
TIER_MIGRATING = "migrating"   # gather enqueued, blob not installed yet
TIER_DEAD = "dead"             # evicted; structure detached
TIER_SPILLING = "spilling"     # host blob, remote publish in flight —
                               # still matchable exactly like TIER_HOST
TIER_REMOTE = "remote"         # blob field holds the cas:// uri

#: Content-address scheme of the artifact store — a TIER_REMOTE node's
#: ``blob`` is ``cas://<sha256hex>``; the hex part is the checksum the
#: promote path re-verifies fetched bytes against.
_CAS = "cas://"

#: Partial (sub-page) leaves kept per parent.
MAX_PARTIALS = 4


class _Node:
    """One page-sized token block. ``block`` is the claimed content
    (len == page_size for full blocks; shorter for partial leaves —
    positions past ``len(block)`` in the page are unclaimed). Exactly one
    of: ``page`` set (device) or ``blob`` set (host: the wire bytes;
    remote: the ``cas://`` uri)."""

    __slots__ = ("block", "page", "tier", "blob", "children", "partials",
                 "parent", "last_used")

    def __init__(self, block: tuple, page: Optional[int], parent):
        self.block = block
        self.page = page
        self.tier = TIER_DEVICE
        self.blob: Optional[bytes] = None
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
    """Radix tree + tier lifecycle over one ``PageAllocator``.

    Device operations are the engine's closures:

    - ``copy_pages_fn(src_ids, dst_ids)`` — pool page copy (COW tails),
      enqueued in stream order with the chunk prefill that reads it;
    - ``upload_pages_fn(page_ids, k, v[, sk, sv])`` — host→device
      promotion of per-page numpy blocks ``[L, pg, KV, Dh]`` (scale rows
      ``[L, pg, KV]`` for an int8 pool);
    - ``fetch_pages_fn(page_ids)`` — the demotion gather: returns
      ``(planes, ready)``, host tensors ``[L, n, pg, ...]`` (k, v, and the
      scale planes of an int8 pool) whose copy completes with ``ready``
      (an event, or None when they are complete already).

    ``pressure_fn`` returns the pool-pressure ratio exported as
    ``kv_tier_pressure`` (>= 1.0 = urgent: demote now even under load);
    None keeps the default rule (free + cached pages down to a quarter of
    the pool).

    ``remote_store`` (None = the third tier is off) is an
    ``ArtifactStore``-shaped object (``put_bytes``/``get_bytes``/
    ``register``/``lookup``); ``fabric_sig`` folds the cache geometry and
    dtype into every registry key, so replicas of different model shapes
    can share one store root without adopting each other's pages."""

    def __init__(self, allocator, page_size: int, *,
                 host_pages: int = 0,
                 demote_after_s: float = 2.0,
                 migrate_batch_pages: int = 32,
                 scan_interval_s: Optional[float] = None,
                 copy_pages_fn: Optional[Callable] = None,
                 upload_pages_fn: Optional[Callable] = None,
                 fetch_pages_fn: Optional[Callable] = None,
                 pressure_fn: Optional[Callable[[], float]] = None,
                 remote_store=None,
                 remote_after_s: Optional[float] = None,
                 remote_deadline_s: Optional[float] = None,
                 fabric_sig: str = ""):
        self._allocator = allocator
        self.page_size = int(page_size)
        self.host_pages = max(0, int(host_pages))
        self.demote_after_s = float(demote_after_s)
        self.migrate_batch_pages = max(1, int(migrate_batch_pages))
        self._remote_store = remote_store
        self.remote_after_s = (float(remote_after_s)
                               if remote_after_s is not None
                               else 2.0 * self.demote_after_s)
        self.remote_deadline_s = (float(remote_deadline_s)
                                  if remote_deadline_s is not None
                                  else env_float("KFTPU_KV_REMOTE_DEADLINE_S",
                                                 0.5))
        self.fabric_sig = str(fabric_sig)
        self._scan_interval = (float(scan_interval_s)
                               if scan_interval_s is not None
                               else max(self.demote_after_s / 4, 0.05))
        self._copy_pages = copy_pages_fn
        self._upload_pages = upload_pages_fn
        self._fetch_pages = fetch_pages_fn
        self._pressure_fn = pressure_fn
        self._root = _Node((), None, None)
        self._by_page: dict[int, _Node] = {}  # lockfree: scheduler-confined
        # Tier transitions and host accounting cross the migration-thread
        # seam (reentrant: an alloc inside a match can fire on_evict back
        # into the index).
        self._lock = threading.RLock()
        self._host_count = 0          # guarded_by: _lock
        self._migrating = 0           # guarded_by: _lock
        self._remote_count = 0        # guarded_by: _lock
        self._spilling = 0            # guarded_by: _lock
        self.stats = {                # guarded_by: _lock
            "prefix_queries": 0, "prefix_hits": 0,
            "tokens_matched": 0, "tokens_cow": 0,
            "cow_copies": 0, "nodes": 0,
            "pages_demoted": 0, "pages_promoted": 0,
            "demote_batches": 0, "demote_dropped": 0,
            "host_evictions": 0, "evictions": 0,
            "demote_wire_bytes": 0, "promote_wire_bytes": 0,
            # Remote third tier: spill (host→store) and remote promotion
            # (store→device) traffic, and every degrade path with its own
            # counter, so attribution names the faulted phase.
            "pages_demoted_remote": 0, "pages_promoted_remote": 0,
            "remote_demote_bytes": 0, "remote_promote_bytes": 0,
            "remote_promote_timeouts": 0, "remote_promote_errors": 0,
            "remote_blobs_corrupt": 0, "remote_registry_hits": 0,
            "remote_spill_errors": 0, "remote_spill_dropped": 0,
        }
        self._last_scan = 0.0         # lockfree: scheduler-confined
        self.last_promoted = 0        # lockfree: scheduler-confined
        self.last_cow_tokens = 0      # lockfree: scheduler-confined
        self._queue: "queue.Queue" = queue.Queue()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        allocator.on_evict = self._on_evict
        if self.host_pages > 0 or self._remote_store is not None:
            self._thread = threading.Thread(
                target=self._migrate_loop, daemon=True, name="kv-migrate")
            self._thread.start()

    # -- observability -------------------------------------------------------

    def pressure(self) -> float:
        """Current pool-pressure ratio (>= 1.0 = urgent)."""
        if self._pressure_fn is not None:
            return float(self._pressure_fn())
        quarter = self._allocator.num_pages // 4
        return quarter / max(self._allocator.available(), 1)

    def host_pages_resident(self) -> int:
        with self._lock:
            return self._host_count

    def remote_pages_resident(self) -> int:
        with self._lock:
            return self._remote_count

    def snapshot(self) -> dict:
        with self._lock:
            out = dict(self.stats)
            out["host_pages_resident"] = self._host_count
            out["migrating_pages"] = self._migrating
            out["remote_pages_resident"] = self._remote_count
            out["spilling_pages"] = self._spilling
        return out

    # -- match (admission path) ----------------------------------------------

    def match_and_acquire(self, tokens: Sequence[int],
                          owner: Optional[str] = None, *,
                          allow_cow: bool = True) -> tuple[list[int], int]:
        """Longest shared prefix of ``tokens``, capped one token short (the
        first sampled token needs real last-token logits). Returns
        ``(pages, covered_tokens)``: device pages the caller now owns one
        reference to each, in table order. Full-block device hits share by
        incref (live, ref>0); host blocks promote in one batched upload; a
        sub-page divergence allocates a fresh private page and copies the
        shared tail (``allow_cow=False`` keeps the match page-aligned, as
        handoff adoption needs). Past the in-memory tree the walk probes
        the remote store's registry, and remote blocks promote in the same
        upload, all under one deadline per match. Pool exhaustion truncates
        the match rather than failing the admission; any failure misses
        cleanly (the prefix is recomputed)."""
        pg = self.page_size
        cap = len(tokens) - 1
        pages: list[int] = []
        promote: list[tuple[int, bytes]] = []
        self.last_promoted = 0
        self.last_cow_tokens = 0
        try:
            return self._match_locked(tokens, owner, allow_cow, pg, cap,
                                      pages, promote)
        except Exception as exc:
            # Balance the books and miss: every acquired page holds exactly
            # one of our references, and a promoted node whose upload may
            # not have landed must not stay matchable.
            with self._lock:
                for pid, _ in promote:
                    node = self._by_page.get(pid)
                    if node is not None:
                        self._drop_subtree(node)
                if pages:
                    self._allocator.free(pages)
            logger.error("radix match failed; recomputing prefix: %s", exc)
            return [], 0

    def _match_locked(self, tokens, owner, allow_cow, pg, cap,
                      pages, promote) -> tuple[list[int], int]:
        from kubeflow_tpu_torch.serve.paged import PagePoolExhausted

        with self._lock:
            self.stats["prefix_queries"] += 1
            # Mirror into the allocator's counters: one hit/query surface
            # whichever index is active.
            self._allocator.stats["prefix_queries"] += 1
            now = time.monotonic()
            covered = 0
            node = self._root
            chain: tuple = ()
            # One deadline for ALL remote-store work of this match (probe
            # and fetch), armed at the first remote touch, so hits that
            # never leave memory pay nothing.
            remote_deadline: Optional[float] = None
            while covered + pg <= cap:
                blk = tuple(tokens[covered:covered + pg])
                child = node.children.get(blk)
                if child is None and self._remote_store is not None:
                    # Out of the in-memory tree: another replica (or a dead
                    # incarnation of this one) may have published this
                    # block — the conversation-failover path.
                    if remote_deadline is None:
                        remote_deadline = (time.monotonic()
                                           + self.remote_deadline_s)
                    child = self._probe_remote_child(
                        node, blk, chain, remote_deadline - time.monotonic())
                if child is None or child.tier in (TIER_MIGRATING,
                                                   TIER_DEAD):
                    break
                if child.tier in (TIER_HOST, TIER_SPILLING):
                    try:
                        pid = self._allocator.alloc(1, owner=owner)[0]
                    except PagePoolExhausted:
                        break
                    if child.tier not in (TIER_HOST, TIER_SPILLING):
                        # The alloc's eviction callback can cascade a
                        # dropped subtree over ``child`` (the COW tail's
                        # hazard): its blob is gone — miss.
                        self._allocator.free([pid])
                        break
                    # Promotion: the node returns to the device tier; the
                    # fresh ref is the matcher's sharer ref, and
                    # ``retained`` keeps the page cached after release. A
                    # SPILLING node promotes the same way: the in-flight
                    # publish holds its own reference to the blob, and its
                    # install discards on the tier check.
                    child.page = pid
                    child.tier = TIER_DEVICE
                    blob, child.blob = child.blob, None
                    self._host_count -= 1
                    self._by_page[pid] = child
                    self._allocator.retained.add(pid)
                    promote.append((pid, blob))
                    self.stats["pages_promoted"] += 1
                elif child.tier == TIER_REMOTE:
                    if remote_deadline is None:
                        remote_deadline = (time.monotonic()
                                           + self.remote_deadline_s)
                    blob = self._fetch_remote_blob(
                        child.blob, remote_deadline - time.monotonic())
                    if blob is None:
                        break        # timed out or corrupt: shorter match
                    try:
                        pid = self._allocator.alloc(1, owner=owner)[0]
                    except PagePoolExhausted:
                        break
                    if child.tier != TIER_REMOTE:
                        self._allocator.free([pid])
                        break
                    child.page = pid
                    child.tier = TIER_DEVICE
                    child.blob = None
                    self._remote_count -= 1
                    self._by_page[pid] = child
                    self._allocator.retained.add(pid)
                    promote.append((pid, blob))
                    self.stats["pages_promoted_remote"] += 1
                    self.stats["remote_promote_bytes"] += len(blob)
                else:
                    # Device hit (possibly still owned by a decoding
                    # request): one more sharer, stamped per owner.
                    self._allocator.incref([child.page], owner=owner)
                child.last_used = now
                pages.append(child.page)
                covered += pg
                chain = chain + (blk,)
                node = child
            # Sub-page tail: the query continues into (or diverges inside)
            # a cached block — copy only the shared part.
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
        if promote:
            self._upload_blobs(promote)
            self.last_promoted = len(promote)
        return pages, covered

    def _cow_tail(self, src: _Node, owner) -> Optional[int]:
        """Fresh private page holding ``src``'s claimed content: a device
        copy for a device source, a blob upload for a host one. Returns the
        page id, or None when the pool is dry or the source is mid-migration,
        in the remote store, or was evicted by this very allocation."""
        from kubeflow_tpu_torch.serve.paged import PagePoolExhausted

        if src.tier not in (TIER_DEVICE, TIER_HOST, TIER_SPILLING):
            return None
        try:
            fresh = self._allocator.alloc(1, owner=owner)[0]
        except PagePoolExhausted:
            return None
        if src.tier not in (TIER_DEVICE, TIER_HOST, TIER_SPILLING):
            # The alloc reclaims ref-0 indexed pages through the eviction
            # callback — under pool pressure the coldest cached page is
            # often ``src`` itself, which arrives here DEAD.
            self._allocator.free([fresh])
            return None
        try:
            if src.tier == TIER_DEVICE:
                self._copy_pages([src.page], [fresh])
            else:
                self._upload_blobs([(fresh, src.blob)])
        except Exception:
            # The fresh ref must not strand on a failed device call.
            self._allocator.free([fresh])
            raise
        self.stats["cow_copies"] += 1
        return fresh

    def _upload_blobs(self, items: list) -> None:
        """ONE batched host→device upload for ``items`` of ``(page_id,
        wire_blob)``. Blobs decode zero-copy; the engine's upload closure
        packs them into its buffer (one host copy on the admission path).
        int8 blobs carry their scale rows through the same upload."""
        ids = [pid for pid, _ in items]
        with self._lock:
            self.stats["promote_wire_bytes"] += sum(
                len(blob) for _, blob in items)
        ks, vs, sks, svs = [], [], [], []
        for _, blob in items:
            k, v, sk, sv = pages_from_wire(blob)
            ks.append(k)
            vs.append(v)
            sks.append(sk)
            svs.append(sv)
        if any(s is not None for s in sks):
            if any(s is None for s in sks):
                raise ValueError(
                    "mixed quantized/full-dtype blobs in one promote batch")
            self._upload_pages(ids, ks, vs, sks, svs)
        else:
            self._upload_pages(ids, ks, vs)

    # -- remote third tier (the fleet-wide KV fabric) -------------------------

    def _remote_key(self, namespace: str, chain: tuple) -> str:
        """Registry name for one radix block chain, the JAX index's string
        for the same chain: the same fabric signature, namespace and token
        blocks give the same name on every replica, which is what makes a
        dead engine's KV discoverable by a survivor that never saw the
        request. Tokens hash as Python ints (a numpy scalar's repr would
        change the key)."""
        chain = tuple(tuple(int(t) for t in blk) for blk in chain)
        h = hashlib.sha256(
            repr((self.fabric_sig, namespace, chain)).encode("utf-8"))
        return "kv-" + h.hexdigest()[:40]

    def _chain_of(self, node: _Node) -> Optional[tuple]:
        # requires_lock: _lock
        """Root-to-node block chain, or None if any hop is a partial leaf
        (sub-page blocks are not remotely addressable: their content is
        position-dependent within an unclaimed page)."""
        chain: list = []
        n = node
        while n is not None and n.parent is not None:
            if len(n.block) != self.page_size:
                return None
            chain.append(n.block)
            n = n.parent
        return tuple(reversed(chain))

    def _namespace_of(self, node: _Node) -> str:
        """The node's KV namespace. The JAX index keeps one root per LoRA
        adapter; the port serves no adapters, so every node is under the
        one root and its namespace is ``""``."""
        return ""

    def _remote_call(self, fn: Callable, timeout_s: float):
        """One store operation under a hard deadline. The store API has no
        timeout of its own, so a wedged store is bounded by a sacrificial
        daemon thread: on timeout the caller degrades to recompute and the
        thread dies with its blocking call whenever the store unwedges (it
        is never joined). Returns ``(ok, value_or_exception)``."""
        if timeout_s <= 0:
            return False, TimeoutError("remote KV deadline exhausted")
        box: dict = {}

        def run():
            try:
                box["v"] = fn()
            # Not swallowed: relayed through the box and re-surfaced to the
            # caller as (False, exc).
            except BaseException as exc:
                box["e"] = exc

        t = threading.Thread(target=run, daemon=True, name="kv-remote-io")
        t.start()
        t.join(timeout_s)
        if t.is_alive():
            return False, TimeoutError("remote KV store deadline")
        if "e" in box:
            return False, box["e"]
        return True, box.get("v")

    def _probe_remote_child(self, parent: _Node, blk: tuple, chain: tuple,
                            budget_s: float) -> Optional[_Node]:
        # requires_lock: _lock (held across the bounded store probe — the
        # sacrificial thread never takes _lock, so no deadlock, and
        # budget_s caps how long admission can stall on it)
        key = self._remote_key(self._namespace_of(parent), chain + (blk,))
        ok, val = self._remote_call(
            lambda: self._remote_store.lookup(key), budget_s)
        if not ok:
            if isinstance(val, TimeoutError):
                self.stats["remote_promote_timeouts"] += 1
            # FileNotFoundError = nobody published this chain: the ordinary
            # cold-prompt miss, not a failure.
            return None
        child = _Node(blk, None, parent)
        child.tier = TIER_REMOTE
        child.blob = val               # the cas:// uri
        parent.children[blk] = child
        self._remote_count += 1
        self.stats["nodes"] += 1
        self.stats["remote_registry_hits"] += 1
        return child

    def _fetch_remote_blob(self, uri: str,
                           budget_s: float) -> Optional[bytes]:
        # requires_lock: _lock (bounded, the probe's contract)
        ok, val = self._remote_call(
            lambda: self._remote_store.get_bytes(uri), budget_s)
        if not ok:
            if isinstance(val, TimeoutError):
                self.stats["remote_promote_timeouts"] += 1
            else:
                self.stats["remote_promote_errors"] += 1
            return None
        blob = val
        if uri.startswith(_CAS) and hashlib.sha256(blob).hexdigest() \
                != uri[len(_CAS):]:
            # Truncated or corrupt blob: the content address is the
            # checksum — reject before any page is allocated.
            self.stats["remote_blobs_corrupt"] += 1
            return None
        return blob

    def _remote_publish(self, blob: bytes, key: str) -> str:
        """Publish one wire blob: CAS put, then registry bind, on the
        migration thread (or the synchronous drain) — never the scheduler.
        A crash between put and register leaves an unregistered blob for
        the GC sweep, never a dangling name."""
        def op(_attempt):
            uri = self._remote_store.put_bytes(blob)
            try:
                self._remote_store.register(key, "0", uri)
            except ValueError:
                # A racing replica bound this chain to its own (equivalent)
                # blob first: the registry points survivors at the first
                # writer's copy; ours stays valid locally.
                pass
            return uri
        return call_with_retry(op, policy=STORE_POLICY,
                               retry_on=(OSError,))

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
        with self._lock:
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
        # requires_lock: _lock
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

    # -- eviction (allocator callback + host capacity) -----------------------

    def _on_evict(self, page: int) -> None:
        """The allocator reclaimed a ref-0 indexed page for a fresh alloc:
        drop the node; its subtree is unreachable now and cascades back to
        the free list (device pages) or out of host memory (blobs)."""
        with self._lock:
            node = self._by_page.pop(page, None)
            if node is None:
                return
            self.stats["evictions"] += 1
            node.page = None             # the allocator owns it again
            self._drop_subtree(node)

    def _drop_subtree(self, node: _Node) -> None:
        # requires_lock: _lock
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
            elif n.tier in (TIER_HOST, TIER_SPILLING):
                n.blob = None
                self._host_count -= 1
            elif n.tier == TIER_REMOTE:
                # The store blob stays: other replicas may still promote
                # from it; unreferenced blobs are the GC sweep's job.
                n.blob = None
                self._remote_count -= 1
            n.tier = TIER_DEAD       # a mid-migration install discards
            n.page = None
            n.children = {}
            n.partials = []
            self.stats["nodes"] -= 1
        if drop_pages:
            self._allocator.drop_cached(drop_pages)

    def _evict_host_lru(self, n: int) -> None:
        # requires_lock: _lock
        while n > 0:
            hosts = [node for node in self._iter_nodes()
                     if node.tier == TIER_HOST]
            if not hosts:
                return
            victim = min(hosts, key=lambda nd: nd.last_used)
            before = self._host_count
            self._drop_subtree(victim)
            self.stats["host_evictions"] += 1
            n -= max(before - self._host_count, 1)

    def _iter_nodes(self):
        # requires_lock: _lock
        stack = list(self._root.children.values()) + self._root.partials
        while stack:
            n = stack.pop()
            yield n
            stack.extend(n.children.values())
            stack.extend(n.partials)

    # -- demotion (scheduler side) + migration thread ------------------------

    def tick(self, now: Optional[float] = None, *,
             busy: bool = False, force: bool = False) -> int:
        """Periodic demotion scan (called from the engine's scheduler step):
        pick cold sharer-free device pages LRU, enqueue ONE batched gather
        and its copy to host, free the device pages (stream order makes
        that safe: the gather reads them before any later kernel can write
        them), and hand the batch to the migration thread. Returns pages
        demoted this pass.

        ``busy`` = the scheduler has foreground work this step. Demotion
        then yields unless the pool is under pressure, where demoting now
        is what saves the cached content from lossy LRU eviction."""
        if self.host_pages <= 0 or self._fetch_pages is None:
            return 0
        now = time.monotonic() if now is None else now
        if not force and now - self._last_scan < self._scan_interval:
            return 0
        self._spill_scan(now, force=force)
        urgent = self.pressure() >= 1.0
        if busy and not urgent and not force:
            return 0
        self._last_scan = now
        with self._lock:
            cands: list[_Node] = []
            # Urgent mode still protects HOT pages (used within two scan
            # windows): demoting a prefix the next arrival matches would
            # buy one free page at the cost of a promotion round trip.
            floor = (0.0 if force
                     else 2 * self._scan_interval if urgent
                     else self.demote_after_s)
            for p in self._allocator.reclaimable_lru():
                node = self._by_page.get(p)
                if node is None or node.tier != TIER_DEVICE:
                    continue
                if now - node.last_used < floor:
                    continue
                cands.append(node)
                if len(cands) >= self.migrate_batch_pages:
                    break
            if not cands:
                return 0
            room = self.host_pages - self._host_count - self._migrating
            if len(cands) > room:
                if force:
                    # Drain mode: never destroy host content to make room
                    # — the next pass's spill frees it losslessly.
                    cands = cands[:max(room, 0)]
                else:
                    self._evict_host_lru(len(cands) - room)
                    room = (self.host_pages - self._host_count
                            - self._migrating)
                    cands = cands[:max(room, 0)]
            if not cands:
                return 0
            ids = [n.page for n in cands]
            planes, ready = self._fetch_pages(ids)
            for n in cands:
                self._by_page.pop(n.page, None)
                n.page = None
                n.tier = TIER_MIGRATING
                self._migrating += 1
            self._allocator.drop_cached(ids)
            self.stats["demote_batches"] += 1
        self._queue.put(("demote", cands, planes, ready))
        return len(ids)

    def _spill_scan(self, now: float, *, force: bool = False) -> None:
        """Aging spill host→store: full-block host blobs idle past
        ``remote_after_s`` go to the migration thread for publishing.
        Spill is proactive (it fires with host room to spare): the point is
        failover durability, so a conversation's KV is in the store before
        its engine dies."""
        if self._remote_store is None:
            return
        spills: list = []
        with self._lock:
            for node in self._iter_nodes():
                if node.tier != TIER_HOST:
                    continue
                if not force and now - node.last_used < self.remote_after_s:
                    continue
                chain = self._chain_of(node)
                if chain is None:
                    continue       # partial leaves stay on the host
                node.tier = TIER_SPILLING
                self._spilling += 1
                # The blob rides the queue item by value: a promotion or
                # eviction racing the publish clears ``node.blob`` without
                # invalidating the bytes in flight.
                spills.append((node, node.blob, self._remote_key(
                    self._namespace_of(node), chain)))
                if len(spills) >= self.migrate_batch_pages:
                    break
        if spills:
            self._queue.put(("spill", spills))

    def _migrate_loop(self) -> None:
        while not self._stop.is_set():
            try:
                # Bounded get: close() pushes a None sentinel, and the
                # timeout rechecks the stop flag if it is lost.
                item = self._queue.get(timeout=1.0)
            except queue.Empty:
                continue
            if item is None:
                return
            if item[0] == "spill":
                self._run_spill(item[1])
                continue
            _, nodes, planes, ready = item
            span = get_tracer().start_span(
                "engine.kv_migrate", direction="demote", pages=len(nodes))
            try:
                if ready is not None:
                    # The batch's own copy event: this thread blocks, the
                    # scheduler's stream never does.
                    ready.synchronize()
                host = [host_array(t) for t in planes]
                k, v = host[0], host[1]
                if len(host) == 4:
                    blobs = [pages_to_wire(k[:, j], v[:, j],
                                           kv_sk=host[2][:, j],
                                           kv_sv=host[3][:, j])
                             for j in range(len(nodes))]
                else:
                    blobs = [pages_to_wire(k[:, j], v[:, j])
                             for j in range(len(nodes))]
            except Exception as exc:
                # A failed batch loses cached content (it was freed on the
                # device already) but never correctness: its nodes leave
                # the tree and the prefix is recomputed.
                logger.error("kv migration batch failed: %s", exc)
                with self._lock:
                    for n in nodes:
                        self._migrating -= 1
                        if n.tier == TIER_MIGRATING:
                            self._drop_subtree(n)
                span.end("error")
                continue
            with self._lock:
                for n, blob in zip(nodes, blobs):
                    self._migrating -= 1
                    if n.tier != TIER_MIGRATING:
                        # Evicted while the bytes were in flight: the
                        # content is unreachable — discard.
                        self.stats["demote_dropped"] += 1
                        continue
                    n.blob = blob
                    n.tier = TIER_HOST
                    self._host_count += 1
                    self.stats["pages_demoted"] += 1
                    self.stats["demote_wire_bytes"] += len(blob)
            span.end("ok")

    def _run_spill(self, spills: list) -> None:
        """Migration-thread half of the host→store spill: publish each blob
        (CAS put + registry bind, retried under ``STORE_POLICY``), then
        install TIER_REMOTE under the lock — or discard if a promotion or
        eviction won the race. A publish failure puts the node back on the
        host tier with a fresh clock, so a dead store degrades to "third
        tier off" instead of a retry hot loop."""
        span = get_tracer().start_span(
            "engine.kv_migrate", direction="spill", pages=len(spills))
        errors = 0
        for node, blob, key in spills:
            try:
                uri = self._remote_publish(blob, key)
            except Exception as exc:
                errors += 1
                with self._lock:
                    self._spilling -= 1
                    if node.tier == TIER_SPILLING:
                        node.tier = TIER_HOST
                        node.last_used = time.monotonic()
                    self.stats["remote_spill_errors"] += 1
                logger.error("kv remote spill failed: %s", exc)
                continue
            with self._lock:
                self._spilling -= 1
                if node.tier != TIER_SPILLING:
                    # Promoted or evicted while the publish was in flight:
                    # the registered blob stays valid fleet content; only
                    # this node's transition is void.
                    self.stats["remote_spill_dropped"] += 1
                    continue
                node.blob = uri
                node.tier = TIER_REMOTE
                self._host_count -= 1
                self._remote_count += 1
                self.stats["pages_demoted_remote"] += 1
                self.stats["remote_demote_bytes"] += len(blob)
        span.end("error" if errors else "ok")

    def spill_all_to_remote(self, timeout_s: float = 10.0) -> int:
        """Scale-down drain: push EVERY publishable cached page out to the
        store — forced demote passes (device→host, no age floor)
        interleaved with forced spills (host→store) until nothing moves —
        so a replica leaving the fleet strands no conversation.
        Scheduler-confined (call with the engine idle or draining).
        Returns pages published."""
        if self._remote_store is None:
            return 0
        before = self.snapshot()["pages_demoted_remote"]
        done = before
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if self._fetch_pages is not None and self.host_pages > 0:
                moved = self.tick(force=True)
            else:
                # No demotion wired: still publish what the host holds.
                moved = 0
                self._spill_scan(time.monotonic(), force=True)
            # The forced tick force-spilled the host tier too; wait both
            # halves out.
            try:
                self.drain_migrations(max(deadline - time.monotonic(), 0.01))
            except TimeoutError:
                break
            now_done = self.snapshot()["pages_demoted_remote"]
            if not moved and now_done == done:
                break        # only unpublishable content (partials) left
            done = now_done
        return done - before

    def drain_migrations(self, timeout_s: float = 5.0) -> None:
        """Wait until no demotion batch or remote spill is in flight
        (tests, audits, the scale-down drain)."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            with self._lock:
                if self._migrating == 0 and self._spilling == 0:
                    return
            time.sleep(0.005)
        raise TimeoutError("kv migration batches still in flight")

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._queue.put(None)
            self._thread.join(timeout=5.0)
            self._thread = None
        if getattr(self._allocator, "on_evict", None) is self._on_evict:
            self._allocator.on_evict = None
