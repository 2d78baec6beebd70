"""Service router: one stable URL per InferenceService, weighted backend
selection, and activator-style request queueing — a copy of
``kubeflow_tpu/serve/router.py`` over the port's model servers (the port
imports nothing of the JAX package). It is the data plane of a fleet:
every request to a service passes through it, and it is what sends a
conversation's next turn to a survivor when its replica dies (the remote
KV tier then lets the survivor adopt the conversation's prefix).

Scale-to-zero: with no ready backends a request does NOT 503 — it parks on
a condition variable and the ``pending`` gauge rises; a controller reads
that gauge as the activation signal, starts a replica, and the next
``set_backends`` wakes every parked request (0→1 cold start). 503 only
after ``queue_timeout``.

Request-lifecycle hardening (Envoy-analog):

- **Deadline-aware timeouts.** The client's remaining budget rides in the
  ``X-Kftpu-Deadline-Ms`` header (default: ``upstream_timeout``); it bounds
  every upstream socket wait, and the remaining budget is re-stamped onto
  the forwarded request so the backend engine can reap the request when
  the client is already gone.
- **Connect-failure retries.** A backend that refuses the connection (zero
  response bytes: nothing reached a model or the client) is retried on a
  different backend up to ``max_retries`` times.
- **Outlier ejection.** ``eject_threshold`` consecutive failures (connect
  failures or 5xx responses) eject a backend for ``eject_period`` seconds;
  after the window the next pick half-opens it — ONE probe request
  (picking re-arms the window so concurrent traffic keeps avoiding it) —
  and a success fully reinstates it. If every backend is ejected the
  router panic-routes to the least-recently-ejected one.
- **Draining.** ``set_draining(url)`` removes a backend from selection
  without touching its in-flight requests (graceful scale-down).
- **Disaggregated pools** (``set_pools``): token-aware placement from each
  backend's scraped ``/metrics`` picks the prefill backend and stamps the
  decode backend (``X-Kftpu-Decode-Backend``) and its alternates
  (``X-Kftpu-Decode-Alts``) on the forwarded request.

Left out of the copy: the JAX router's history-backed signal source
(``set_metrics_source``, fed by the fleet metrics collector the port does
not have), and the thread audit its ``stop`` runs under
``KFTPU_SANITIZE=threads`` (the port has no thread sanitizer).
"""

from __future__ import annotations

import hashlib
import itertools
import json
import random
import sys
import threading
import time
import traceback
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

# Header names come from the one module that owns every X-Kftpu-* name
# (core/headers.py); DEADLINE_HEADER/QOS_HEADER are re-exported here for
# the router's importers (scripts, tests).
from kubeflow_tpu_torch.core.headers import (
    DEADLINE_HEADER, DECODE_ALTS_HEADER, DECODE_BACKEND_HEADER,
    MODEL_HEADER, QOS_HEADER, TRACE_HEADER,
)
from kubeflow_tpu_torch.obs.registry import (
    MetricsRegistry, contract_note_header, contract_note_series,
    parse_exposition,
)
from kubeflow_tpu_torch.obs.fleet import (
    ROUTER_SPANS_EXPORT_PATH, spans_export_payload,
)
from kubeflow_tpu_torch.obs.trace import debug_traces_payload, get_tracer
from kubeflow_tpu_torch.serve.retry import PROBE_POLICY, call_with_retry

#: Engine series the token-aware router scrapes off every pooled
#: backend's /metrics for placement — the router's half of the
#: engine↔router metrics contract: prefills place on
#: least-pending-prefill-tokens, decodes on least-REFERENCED-KV-pages,
#: in-flight breaks ties (and stands in for pages on dense engines,
#: which always report zero resident pages). ``kv_pages_resident`` is
#: the resident-REFERENCED gauge (tiered KV cache split): ref-0 cached
#: prefix content is freely evictable and must not read as decode
#: load, so the router also scrapes ``kv_pages_cached`` and prefers —
#: between equally-loaded decode backends — the one holding MORE
#: cached prefix content (its prefix-hit odds are higher).
#: ``kv_pages_remote`` (the remote KV tier) is scraped so
#: placement can see how much of a backend's prefix content already
#: spilled to the shared remote tier — informational today (any replica
#: can promote remote pages), but it keeps the gauge two-sided.
ROUTER_SCRAPE_SERIES = (
    "kftpu_engine_pending_prefill_tokens",
    "kftpu_engine_kv_pages_resident",
    "kftpu_engine_kv_pages_cached",
    "kftpu_engine_kv_pages_remote",
    "kftpu_engine_adapters_resident",
    "kftpu_serving_in_flight",
)


def _rendezvous(key: str, url: str) -> int:
    """Rendezvous (highest-random-weight) score of ``url`` for an
    affinity ``key``: every router instance independently agrees on the
    same preferred backend with no shared state, and removing a backend
    only remaps the keys that hashed to it (no global reshuffle)."""
    digest = hashlib.sha256(f"{key}|{url}".encode()).digest()
    return int.from_bytes(digest[:8], "big")


def _affinity_key(path: str, body: Optional[bytes]) -> Optional[str]:
    """Radix-prefix affinity key for a generation request: the head of
    the prompt (or the first chat message). Multi-turn conversations
    share their prompt head verbatim — the system prompt / first turn —
    so hashing it routes every turn of a session to the SAME decode
    replica, whose radix tree still holds the session's prefix pages.
    64 chars is plenty to separate sessions and cheap to hash; requests
    without a recognizable prompt get no affinity (pure load placement).
    """
    if not body or not path.startswith(("/v1/completions",
                                        "/v1/chat/completions")):
        return None
    try:
        req = json.loads(body)
    except ValueError:
        return None
    head = ""
    if isinstance(req.get("prompt"), str):
        head = req["prompt"]
    # "messages" is the client-authored OpenAI chat field.
    elif isinstance(req.get("messages"), list) and req["messages"]:
        first = req["messages"][0]
        if isinstance(first, dict):
            head = str(first.get("content") or "")
    return head[:64] or None


def quiet_handle_error(httpd) -> None:
    """Replace socketserver's print-a-traceback error hook on ``httpd``:
    connection breakage (a client hanging up mid-response) is ROUTINE under
    load shedding and chaos testing, not a bug worth a stderr traceback.
    Anything else still prints."""

    def handle_error(request, client_address):
        exc = sys.exc_info()[1]
        if isinstance(exc, (ConnectionError, TimeoutError)):
            return
        traceback.print_exc()

    httpd.handle_error = handle_error

#: Local (non-proxied) router endpoints. The spans-export path is owned
#: by obs/fleet.py (the collector registers it as a drain source).
ROUTER_METRICS_PATH = "/-/router/metrics"
ROUTER_TRACES_PATH = "/-/router/debug/traces"
ROUTER_SPANS_PATH = ROUTER_SPANS_EXPORT_PATH


class Router:
    """Weighted HTTP proxy over predictor replicas.

    Backends are registered per traffic group (e.g. "latest"/"previous"
    during a canary rollout), each group with a weight percent; requests
    pick a group by weight, then round-robin inside it."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 queue_timeout: float = 120.0, *,
                 upstream_timeout: float = 600.0,
                 eject_threshold: int = 3,
                 eject_period: float = 5.0,
                 max_retries: int = 2):
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._groups: dict[str, list[str]] = {}    # guarded_by: _lock
        self._weights: dict[str, int] = {}         # guarded_by: _lock
        self._rr = itertools.count()    # lockfree: next() is GIL-atomic
        self._pending = 0               # guarded_by: _lock
        self._last_activity = 0.0   # guarded_by: _lock (monotonic stamp)
        self._closed = False            # guarded_by: _lock
        self.queue_timeout = queue_timeout
        self.upstream_timeout = upstream_timeout
        self.eject_threshold = max(1, int(eject_threshold))
        self.eject_period = eject_period
        self.max_retries = max(0, int(max_retries))
        # outlier-ejection state (all under self._lock)
        self._fails: dict[str, int] = {}           # guarded_by: _lock
        self._ejected_until: dict[str, float] = {}  # guarded_by: _lock
        self._draining: set[str] = set()            # guarded_by: _lock
        # ``panic_total``/``probe_total`` mirror panic_picks/
        # half_open_probes under the stable metric names the autoscaler
        # post-mortems key on (kftpu_router_panic_total distinguishes
        # "backends ejected" from "backends slow").
        self.stats = {"picks": 0, "retries": 0,    # guarded_by: _lock
                      "connect_failures": 0,
                      "http_5xx": 0, "ejections": 0, "half_open_probes": 0,
                      "panic_picks": 0, "panic_total": 0, "probe_total": 0,
                      "queue_timeouts": 0,
                      "deadline_exhausted": 0,
                      "disagg_picks": 0, "disagg_fallbacks": 0,
                      "affinity_hits": 0, "affinity_misses": 0}
        # Disaggregated fleet mode (set_pools): role -> backend urls,
        # plus the freshest scraped placement signals per backend.
        self._pools: dict[str, list[str]] = {}     # guarded_by: _lock
        self._signals: dict[str, dict] = {}        # guarded_by: _lock
        # Scrape-origin health: a pool member that stops answering its
        # /metrics scrape gets ejected even though it takes no proxied
        # traffic (a dead DECODE backend would otherwise be picked
        # forever, costing every request a failed handoff + recompute).
        # Kept separate from the request-failure counter so a healthy
        # scrape can never launder real traffic failures.
        self._scrape_fails: dict[str, int] = {}    # guarded_by: _lock
        self.scrape_interval = 0.25
        self._scrape_stop = threading.Event()
        self._scrape_thread: Optional[threading.Thread] = None
        self.httpd = ThreadingHTTPServer((host, port), _make_handler(self))
        self.httpd.daemon_threads = True
        quiet_handle_error(self.httpd)
        self.port = self.httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def set_backends(self, groups: dict[str, list[str]],
                     weights: Optional[dict[str, int]] = None) -> None:
        with self._cond:
            self._groups = {g: list(urls) for g, urls in groups.items() if urls}
            if weights:
                self._weights = dict(weights)
            else:
                self._weights = {g: 100 // max(len(self._groups), 1)
                                 for g in self._groups}
            # Prune per-backend state for urls that left the rotation —
            # ports get reused, and a recycled port must not inherit its
            # predecessor's failure history.
            live = {u for urls in self._groups.values() for u in urls}
            for d in (self._fails, self._ejected_until, self._scrape_fails):
                for u in [u for u in d if u not in live]:
                    d.pop(u)
            self._draining &= live
            if self._groups:
                self._cond.notify_all()   # wake cold-start queued requests

    # -- disaggregated pools (token-aware placement) ------------------------

    def set_pools(self, pools: dict[str, list[str]], *,
                  scrape: bool = True) -> None:
        """Register role-specialized backend pools (``prefill`` /
        ``decode`` / ``unified``). All pool members join the regular
        rotation (so ejection, draining, panic routing and scale-from-
        zero parking keep working unchanged); placement then routes
        every request through ``pick_disaggregated`` on the scraped
        token signals. An empty dict leaves fleet mode."""
        union: list[str] = []
        for urls in pools.values():
            for u in urls:
                if u not in union:
                    union.append(u)
        self.set_backends({"latest": union} if union else {})
        with self._lock:
            self._pools = {r: list(urls) for r, urls in pools.items()
                           if urls}
            live = set(union)
            for u in [u for u in self._signals if u not in live]:
                self._signals.pop(u)
        if scrape and union:
            self.start_signal_scrape()

    @property
    def has_pools(self) -> bool:
        with self._lock:
            return bool(self._pools)

    def note_signals(self, url: str, signals: dict) -> None:
        """Feed one backend's placement signals (the scrape loop's
        writer; tests and controllers may inject directly)."""
        with self._lock:
            self._signals[url] = dict(signals)

    def start_signal_scrape(self) -> None:
        if self._scrape_thread is not None and \
                self._scrape_thread.is_alive():
            return
        self._scrape_stop.clear()
        self._scrape_thread = threading.Thread(
            target=self._scrape_loop, daemon=True, name="router-scrape")
        self._scrape_thread.start()

    def _scrape_loop(self) -> None:
        while not self._scrape_stop.wait(self.scrape_interval):
            self.scrape_signals()

    def scrape_signals(self) -> None:
        """One pass over every pooled backend's /metrics exposition
        (the same grammar the SLO autoscaler scrapes through). An
        unreachable backend keeps its last-known signals — ejection,
        not staleness, is what removes it from placement."""
        with self._lock:
            urls = [u for urls in self._pools.values() for u in urls]
        for url in dict.fromkeys(urls):
            def _fetch(_attempt, url=url):
                with urllib.request.urlopen(url + "/metrics",
                                            timeout=1.0) as r:
                    return r.read().decode()

            try:
                # Shared backoff policy (serve/retry.py): one transient
                # scrape hiccup must not advance a backend toward
                # scrape-origin ejection.
                text = call_with_retry(_fetch, policy=PROBE_POLICY)
            except OSError:
                with self._lock:
                    self._scrape_fails[url] = \
                        self._scrape_fails.get(url, 0) + 1
                    if self._scrape_fails[url] >= self.eject_threshold:
                        now = time.monotonic()
                        if self._ejected_until.get(url, 0.0) <= now:
                            self.stats["ejections"] += 1
                        self._ejected_until[url] = now + self.eject_period
                continue
            with self._lock:
                self._scrape_fails.pop(url, None)
            sig = self._parse_signals(text)
            if sig is not None:
                self.note_signals(url, sig)

    @staticmethod
    def _parse_signals(text: str) -> Optional[dict]:
        out = {"pending_prefill_tokens": 0.0, "kv_pages_resident": 0.0,
               "kv_pages_cached": 0.0, "kv_pages_remote": 0.0,
               "in_flight": 0.0, "adapters": frozenset()}
        adapters: set[str] = set()
        try:
            samples = parse_exposition(text)
        except ValueError:
            return None
        for name, _labels, value in samples:
            if name in ROUTER_SCRAPE_SERIES:
                # Contract audit: the router CONSUMED this series
                # (no-op unless KFTPU_SANITIZE=contract).
                contract_note_series(name, "consumed")
            if name == "kftpu_engine_pending_prefill_tokens":
                out["pending_prefill_tokens"] += value
            elif name == "kftpu_engine_kv_pages_resident":
                out["kv_pages_resident"] += value
            elif name == "kftpu_engine_kv_pages_cached":
                out["kv_pages_cached"] += value
            elif name == "kftpu_engine_kv_pages_remote":
                out["kv_pages_remote"] += value
            elif name == "kftpu_engine_adapters_resident":
                # Which LoRA adapters are HOT on this backend: the
                # model-id routing signal (one adapter-labeled sample
                # per resident adapter; the 0 sample has no label).
                a = _labels.get("adapter")
                if a and value > 0:
                    adapters.add(a)
            elif name == "kftpu_serving_in_flight":
                out["in_flight"] += value
        out["adapters"] = frozenset(adapters)
        return out

    def _healthy_locked(self, urls, exclude: frozenset,
                        now: float) -> list[str]:
        return [u for u in urls
                if u not in exclude and u not in self._draining
                and self._ejected_until.get(u, 0.0) <= now]

    def pick_disaggregated(self, exclude: frozenset = frozenset(), *,
                           affinity: Optional[str] = None
                           ) -> tuple[Optional[str], Optional[str]]:
        """Token-aware placement: ``(backend, decode_target)``.

        Healthy prefill AND decode pools → the least-pending-prefill-
        tokens prefill backend carries the request, stamped with the
        least-resident-KV-pages decode backend for its handoff. An
        ``affinity`` key (the request's prompt head) overrides the
        load-based decode pick with its rendezvous-hash preferred
        replica WHEN that replica is healthy — every turn of a session
        lands where the session's radix prefix is warm — and falls
        through to load placement (``affinity_misses``) when it is not:
        affinity is a cache hint, never a health exemption. A pool
        with no healthy member → unified fallback: any healthy backend
        (unified first, then decode, then prefill — every role serves a
        whole request locally), no handoff header. Everything ejected →
        panic-route like the classic picker. ``(None, None)`` = nothing
        at all to try."""
        now = time.monotonic()
        with self._lock:
            rot = next(self._rr)
            prefills = self._healthy_locked(
                self._pools.get("prefill", ()), exclude, now)
            decodes = self._healthy_locked(
                self._pools.get("decode", ()), exclude, now)
            if prefills and decodes:
                def sig(u):
                    return self._signals.get(u, {})

                # Rotate before min: equal signals round-robin instead
                # of pinning one backend (min is stable).
                prefills = prefills[rot % len(prefills):] \
                    + prefills[:rot % len(prefills)]
                decodes = decodes[rot % len(decodes):] \
                    + decodes[:rot % len(decodes)]
                p = min(prefills,
                        key=lambda u: (sig(u).get("pending_prefill_tokens",
                                                  0.0),
                                       sig(u).get("in_flight", 0.0)))
                # Referenced pages are load; cached pages are an asset
                # (more cached prefix content = better hit odds), so
                # among equally-loaded decode backends prefer the
                # warmer cache (negated in the ascending-min key).
                d = min(decodes,
                        key=lambda u: (sig(u).get("kv_pages_resident", 0.0),
                                       sig(u).get("in_flight", 0.0),
                                       -sig(u).get("kv_pages_cached", 0.0)))
                if affinity:
                    # The preferred replica is computed over the WHOLE
                    # decode pool (not just the healthy slice): a key
                    # must keep preferring its home replica through a
                    # transient ejection, so a miss here means "home is
                    # down, go cold elsewhere", not a silent remap.
                    pool = self._pools.get("decode", ())
                    home = max(pool, key=lambda u: _rendezvous(
                        affinity, u)) if pool else None
                    if home is not None and home in decodes:
                        d = home
                        self.stats["affinity_hits"] += 1
                    else:
                        self.stats["affinity_misses"] += 1
                self.stats["disagg_picks"] += 1
                return p, d
            for pool in ("unified", "decode", "prefill"):
                ok = self._healthy_locked(self._pools.get(pool, ()),
                                          exclude, now)
                if ok:
                    self.stats["disagg_fallbacks"] += 1
                    return ok[rot % len(ok)], None
            suspects = [u for urls in self._pools.values() for u in urls
                        if u not in exclude and u not in self._draining]
            if suspects:
                self.stats["panic_picks"] += 1
                self.stats["panic_total"] += 1
                return min(suspects,
                           key=lambda u: self._ejected_until.get(u, 0.0)), \
                    None
            return None, None

    def decode_alternates(self, primary: Optional[str],
                          exclude: frozenset = frozenset(), *,
                          n: int = 2) -> tuple[str, ...]:
        """Up to ``n`` healthy decode-pool members besides ``primary`` —
        the prefill replica's retry ladder (``X-Kftpu-Decode-Alts``):
        when its handoff to the primary decode target fails it retries
        against these, in order, before degrading to local recompute.
        Stamped by the router because only the router knows pool health;
        the prefill replica never guesses at fleet membership."""
        now = time.monotonic()
        with self._lock:
            ok = self._healthy_locked(self._pools.get("decode", ()),
                                      exclude, now)
        return tuple(u for u in ok if u != primary)[:n]

    # -- outlier ejection / draining ----------------------------------------

    def note_backend_failure(self, url: str, *, connect: bool = False) -> None:
        """One failed request against ``url`` (connect failure or 5xx).
        ``eject_threshold`` consecutive failures eject it for
        ``eject_period`` seconds."""
        with self._lock:
            self._fails[url] = self._fails.get(url, 0) + 1
            self.stats["connect_failures" if connect else "http_5xx"] += 1
            if self._fails[url] >= self.eject_threshold:
                self._ejected_until[url] = time.monotonic() + self.eject_period
                self.stats["ejections"] += 1

    def note_backend_success(self, url: str) -> None:
        with self._lock:
            self._fails.pop(url, None)
            self._ejected_until.pop(url, None)

    def set_draining(self, url: str, draining: bool = True) -> None:
        """Mark a backend draining: new requests never pick it; in-flight
        requests (already connected) finish undisturbed."""
        with self._lock:
            if draining:
                self._draining.add(url)
            else:
                self._draining.discard(url)

    def count(self, stat: str, n: int = 1) -> None:
        with self._lock:
            self.stats[stat] = self.stats.get(stat, 0) + n

    def snapshot(self) -> dict:
        now = time.monotonic()
        with self._lock:
            return dict(self.stats, pending=self._pending,
                        backends=sum(len(u) for u in self._groups.values()),
                        ejected=sum(1 for t in self._ejected_until.values()
                                    if t > now),
                        draining=len(self._draining))

    @property
    def pending(self) -> int:
        """Requests parked waiting for a backend (the activation signal)."""
        with self._lock:
            return self._pending

    @property
    def last_activity(self) -> float:
        """Monotonic timestamp of the most recent request arrival or
        completion through this router. The KPA-analog idle clock counts
        from here — from *traffic*, not from scale events — so a replica
        that just answered a request (however slow the cold start was) is
        guaranteed a full quiet cooldown before it can be culled."""
        with self._lock:
            return self._last_activity

    def note_activity(self) -> None:
        with self._lock:
            self._last_activity = time.monotonic()

    # -- backend selection ---------------------------------------------------

    def _eligible_locked(self, exclude: frozenset,
                         now: float) -> dict[str, list[str]]:
        out: dict[str, list[str]] = {}
        for g, urls in self._groups.items():
            ok = [u for u in urls
                  if u not in exclude and u not in self._draining
                  and self._ejected_until.get(u, 0.0) <= now]
            if ok:
                out[g] = ok
        return out

    def _pick_locked(self, exclude: frozenset = frozenset(),
                     model: Optional[str] = None) -> Optional[str]:
        now = time.monotonic()
        eligible = self._eligible_locked(exclude, now)
        if not eligible:
            # Panic routing (Envoy panic-threshold analog): every backend is
            # ejected — try the least-recently-ejected suspect rather than
            # park the request into a guaranteed queue timeout.
            suspects = [u for urls in self._groups.values() for u in urls
                        if u not in exclude and u not in self._draining]
            if not suspects:
                return None
            self.stats["panic_picks"] += 1
            self.stats["panic_total"] += 1
            return min(suspects,
                       key=lambda u: self._ejected_until.get(u, 0.0))
        groups = [(g, self._weights.get(g, 0)) for g in eligible]
        total = sum(w for _, w in groups) or len(groups)
        r = random.uniform(0, total)
        acc = 0.0
        chosen = groups[-1][0]
        for g, w in groups:
            acc += w if total else 1
            if r <= acc:
                chosen = g
                break
        urls = eligible[chosen]
        if model is not None:
            # Model-id routing (multi-tenant LoRA): prefer a backend
            # that already has the adapter HOT — a cold pick pays a
            # hot-load (and possibly an eviction) before its prefill.
            # Falls back to the whole rotation when nobody has it (the
            # pick itself warms that backend). Round-robin WITHIN the
            # warm set keeps one popular adapter from pinning a single
            # replica.
            warm = [u for u in urls
                    if model in self._signals.get(u, {}).get(
                        "adapters", ())]
            if warm:
                urls = warm
        url = urls[next(self._rr) % len(urls)]
        if url in self._ejected_until:
            # Expired ejection window: this pick IS the half-open probe.
            # Re-arm the window so concurrent traffic keeps avoiding the
            # backend until the probe's verdict (success clears the state,
            # failure re-ejects).
            self._ejected_until[url] = now + self.eject_period
            self.stats["half_open_probes"] += 1
            self.stats["probe_total"] += 1
        return url

    def pick(self, exclude: frozenset = frozenset(),
             model: Optional[str] = None) -> Optional[str]:
        with self._lock:
            return self._pick_locked(exclude, model=model)

    def pick_or_wait(self, timeout: Optional[float] = None,
                     exclude: frozenset = frozenset(),
                     model: Optional[str] = None) -> Optional[str]:
        """Pick a backend, queueing until one registers (scale-from-zero
        path). Returns None only after ``timeout`` (default: the router's
        queue_timeout) with still no backend."""
        deadline = time.monotonic() + (
            timeout if timeout is not None else self.queue_timeout)
        with self._cond:
            backend = self._pick_locked(exclude, model=model)
            if backend is not None:
                return backend
            self._pending += 1
            try:
                while not self._closed:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        return None
                    self._cond.wait(remaining)
                    backend = self._pick_locked(exclude, model=model)
                    if backend is not None:
                        return backend
                return None   # router torn down: fail fast, don't hold 120s
            finally:
                self._pending -= 1

    @property
    def url(self) -> str:
        return f"http://127.0.0.1:{self.port}"

    def start(self) -> None:
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True, name="router")
        self._thread.start()

    def stop(self) -> None:
        self._scrape_stop.set()
        if self._scrape_thread is not None:
            self._scrape_thread.join(timeout=5.0)
            self._scrape_thread = None
        with self._cond:
            self._closed = True
            self._cond.notify_all()   # release every parked request
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None


def _make_handler(router: Router):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, *args) -> None:
            pass

        def _send(self, code: int, data: bytes,
                  ctype: str = "application/json") -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def _error(self, code: int, message: str) -> None:
            self._send(code, f'{{"error": "{message}"}}'.encode())

        def _router_metrics(self) -> None:
            snap = router.snapshot()
            reg = MetricsRegistry()
            for k, v in sorted(snap.items()):
                reg.gauge(f"kftpu_router_{k}").set(v)
            self._send(200, reg.render().encode(), ctype="text/plain")

        def _proxy(self) -> None:
            if self.path == ROUTER_METRICS_PATH:
                # Observability scrape, not traffic: must not feed the
                # KPA-analog activity clock (a 1 s scrape loop would pin
                # the service out of scale-to-zero forever).
                return self._router_metrics()
            if self.path.split("?", 1)[0] == ROUTER_TRACES_PATH:
                return self._send(
                    200, json.dumps(debug_traces_payload(self.path),
                                    default=str).encode())
            if self.path.split("?", 1)[0] == ROUTER_SPANS_PATH:
                # Fleet-trace drain (obs/fleet.py) — observability, not
                # traffic: must not feed the KPA activity clock either.
                return self._send(
                    200, json.dumps(spans_export_payload(process="router"),
                                    default=str).encode())
            router.note_activity()
            try:
                self._proxy_inner()
            finally:
                # Stamp at COMPLETION too: a request slower than the idle
                # cooldown (e.g. a cold start that had to spawn + compile)
                # must restart the clock when it answers, or the replica
                # gets culled the moment in_flight drops back to zero.
                router.note_activity()

        def _budget_s(self) -> float:
            """Remaining client budget (seconds): deadline header if the
            client sent one, capped by the router's upstream timeout."""
            budget = router.upstream_timeout
            hdr = self.headers.get(DEADLINE_HEADER)
            contract_note_header(DEADLINE_HEADER, direction="read")
            if hdr:
                try:
                    budget = min(budget, max(float(hdr) / 1e3, 0.0))
                except ValueError:
                    pass
            return budget

        def _proxy_inner(self) -> None:
            # Trace root (or join, when the client already carries a
            # context): every hop below — backend pick, upstream request,
            # response relay — is annotated on this span, and the context
            # rides the X-Kftpu-Trace header so the model server and the
            # engine scheduler continue the SAME trace id.
            tracer = get_tracer()
            contract_note_header(TRACE_HEADER, direction="read")
            with tracer.span(
                    "router.request",
                    parent=tracer.extract(self.headers.get(TRACE_HEADER)),
                    path=self.path) as sp:
                self._proxy_upstream(sp)

        def _proxy_upstream(self, sp) -> None:
            deadline = time.monotonic() + self._budget_s()
            n = int(self.headers.get("Content-Length", 0))
            body = self.rfile.read(n) if n else None
            # Model-id routing key (multi-tenant LoRA): requests naming
            # a model prefer backends already serving it hot.
            contract_note_header(MODEL_HEADER, direction="read")
            model_id = (self.headers.get(MODEL_HEADER) or "").strip() \
                or None
            tried: set[str] = set()
            first_attempt = True
            while True:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    router.count("deadline_exhausted")
                    sp.set_attrs(code=504)
                    return self._error(504, "deadline exhausted in router")
                decode_target = None
                if router.has_pools:
                    # Disaggregated fleet: token-aware placement decides
                    # BOTH hops here — the prefill backend that carries
                    # the request and the decode backend its KV hands
                    # off to (stamped on the forwarded request below).
                    # The prompt head rides along as the prefix-affinity
                    # key so a session's turns chase their warm replica.
                    backend, decode_target = router.pick_disaggregated(
                        exclude=frozenset(tried),
                        affinity=_affinity_key(self.path, body))
                elif first_attempt:
                    # Only the first pick parks (scale-from-zero): a retry
                    # already had a live-looking rotation moments ago, so a
                    # blocking wait would just burn the client's budget.
                    backend = router.pick_or_wait(
                        timeout=min(remaining, router.queue_timeout),
                        exclude=frozenset(tried), model=model_id)
                else:
                    backend = router.pick(exclude=frozenset(tried),
                                          model=model_id)
                if backend is None:
                    if tried:
                        # Retried through the whole rotation: every backend
                        # refused the connection — a backend-side outage,
                        # not a routing/queue condition.
                        sp.set_attrs(code=502)
                        return self._error(
                            502, "backend unreachable: all backends failed")
                    router.count("queue_timeouts")
                    sp.set_attrs(code=503)
                    return self._error(
                        503, "no ready backends (queue timeout)")
                router.count("picks")
                sp.set_attrs(backend=backend)
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    router.count("deadline_exhausted")
                    sp.set_attrs(code=504)
                    return self._error(504, "deadline exhausted in router")
                fwd_headers = {
                    "Content-Type": self.headers.get(
                        "Content-Type", "application/json"),
                    # Forward the REMAINING budget: the replica stamps
                    # the engine-side request deadline from it.
                    DEADLINE_HEADER: str(int(remaining * 1e3)),
                }
                if self.headers.get(QOS_HEADER):
                    # QoS class rides to the replica verbatim — the
                    # engine scheduler enforces the class policy.
                    contract_note_header(QOS_HEADER, direction="read")
                    fwd_headers[QOS_HEADER] = self.headers[QOS_HEADER]
                if decode_target:
                    # Handoff placement: the prefill replica POSTs its
                    # KV to exactly this decode-pool member — and the
                    # alternates ladder it may retry against when that
                    # member dies between this pick and the handoff.
                    fwd_headers[DECODE_BACKEND_HEADER] = decode_target
                    alts = router.decode_alternates(
                        decode_target, frozenset(tried))
                    if alts:
                        fwd_headers[DECODE_ALTS_HEADER] = ",".join(alts)
                if model_id:
                    # The replica resolves the model id itself (adapter
                    # hot-load on miss, 404 on unknown).
                    fwd_headers[MODEL_HEADER] = model_id
                trace_hdr = get_tracer().inject(sp)
                if trace_hdr:
                    fwd_headers[TRACE_HEADER] = trace_hdr
                # Contract audit (KFTPU_SANITIZE=contract): record which
                # X-Kftpu-* headers actually ride this hop; no-op when off.
                for h in fwd_headers:
                    if h.startswith("X-Kftpu"):
                        contract_note_header(h, direction="set")
                req = urllib.request.Request(
                    backend + self.path, data=body, method=self.command,
                    headers=fwd_headers)
                try:
                    resp = urllib.request.urlopen(req, timeout=remaining)
                except urllib.error.HTTPError as exc:
                    # A response arrived: forward it verbatim. 5xx counts
                    # toward outlier ejection (the Envoy consecutive-5xx
                    # rule) but is NOT retried — the backend consumed the
                    # request, and generation is not idempotent.
                    if exc.code >= 500:
                        router.note_backend_failure(backend)
                    else:
                        router.note_backend_success(backend)
                    sp.set_attrs(code=exc.code)
                    data = exc.read()
                    self._send(exc.code, data, ctype=exc.headers.get(
                        "Content-Type", "application/json"))
                    return
                except OSError as exc:
                    # Connection-level failure before any response byte:
                    # nothing reached a model, nothing reached the client —
                    # the ONE case where a retry on a different backend is
                    # unconditionally safe.
                    router.note_backend_failure(backend, connect=True)
                    sp.add_event("connect_failure", backend=backend)
                    tried.add(backend)
                    first_attempt = False
                    if len(tried) <= router.max_retries:
                        router.count("retries")
                        continue
                    sp.set_attrs(code=502)
                    return self._error(502, f"backend unreachable: {exc}")
                def read_upstream(*args):
                    # Mid-response read failures are the BACKEND's fault
                    # (it died streaming) — distinct from a client hang-up
                    # on the write side, which must not eject a healthy
                    # backend.
                    try:
                        return resp.read(*args)
                    except OSError:
                        router.note_backend_failure(backend)
                        raise

                sp.set_attrs(code=resp.status)
                try:
                    with resp:
                        self.send_response(resp.status)
                        ctype = resp.headers.get("Content-Type",
                                                 "application/json")
                        self.send_header("Content-Type", ctype)
                        if "event-stream" in ctype:
                            self.send_header("Transfer-Encoding", "chunked")
                            self.end_headers()
                            while True:
                                piece = read_upstream(512)
                                if not piece:
                                    break
                                self.wfile.write(
                                    f"{len(piece):x}\r\n".encode()
                                    + piece + b"\r\n")
                                self.wfile.flush()
                            self.wfile.write(b"0\r\n\r\n")
                        else:
                            data = read_upstream()
                            self.send_header("Content-Length",
                                             str(len(data)))
                            self.end_headers()
                            self.wfile.write(data)
                except OSError:
                    # Response bytes may already be on the wire, so no
                    # retry — close the connection, which is the explicit
                    # error a streaming client can detect.
                    self.close_connection = True
                    return
                router.note_backend_success(backend)
                return

        do_GET = _proxy
        do_POST = _proxy

    return Handler
