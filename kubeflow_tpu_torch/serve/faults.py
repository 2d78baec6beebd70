"""Serving-path fault injection — the backend-level half of
``kubeflow_tpu/serve/faults.py``, copied for the port (it imports nothing
of the JAX package). In process, no control plane needed:

- ``kill_model_server`` is the in-process SIGKILL analog for a
  ``ModelServer``: the listener vanishes (new connections are refused —
  the router sees connect failures and ejects) and the engine scheduler
  halts where it stands, leaving in-flight requests to the
  deadline/cancellation machinery.
- ``ChaosStore`` wraps an ``ArtifactStore`` for the remote KV tier:
  wedged reads, truncated blobs, injected errors.
- ``ChaosProxy`` wraps any backend URL and injects 5xx bursts, added
  latency, wedges (accept, never answer), hard connection drops and
  dropped responses — the Envoy-fault-filter analog for router and server
  tests.

The replica-level ``ServeFaultInjector`` of the JAX module kills or wedges
a replica of a live InferenceService through the control plane's worker
runtime, which the port does not have yet.
"""

from __future__ import annotations

import json
import logging
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from kubeflow_tpu_torch.core.headers import FORWARD_HEADERS
from kubeflow_tpu_torch.obs.registry import contract_note_header
from kubeflow_tpu_torch.serve.router import quiet_handle_error

logger = logging.getLogger("kubeflow_tpu_torch.serve.faults")


def kill_model_server(server) -> None:
    """In-process SIGKILL analog for a ModelServer (tests/chaos harness).

    After this call: the HTTP listener is gone (new connections are
    refused, so the router records connect failures, retries elsewhere,
    and ejects the backend) and the engine's scheduler loop halts without
    any drain — in-flight requests are stranded exactly as a real process
    kill strands them, and must be resolved by the caller-side timeout /
    cancellation machinery, never by luck. The engine object itself stays
    steppable: a recovery audit can drive ``engine.step()`` to let the
    reaper release stranded slots/pages and prove refcount balance."""
    try:
        server.httpd.shutdown()
        server.httpd.server_close()
    except OSError:
        pass
    if server.engine is not None:
        server.engine._stop.set()
        server.engine._wake.set()
    logger.info("killed model server %s (port %s)", server.name, server.port)


class ChaosStore:
    """Artifact-store fault middleman for the remote KV tier:
    hand it to the tiered cache in place of the real ``ArtifactStore``
    and turn knobs mid-traffic. The store is the fabric's third tier, so
    its failure modes are serving incidents, not batch-job retries:

    - ``wedge_promote()`` / ``unwedge()``: reads (``lookup``/
      ``get_bytes``) block until released — a hung NFS/object-store
      endpoint. The promote-with-deadline machinery must degrade the
      match to recompute, never wedge admission.
    - ``truncate_next(n)``: the next ``n`` ``get_bytes`` return the blob
      cut in half — a torn write / partial read. The content-address
      checksum must reject it (``remote_blobs_corrupt``) and degrade.
    - ``fail_next(n)``: the next ``n`` calls raise ``OSError`` — the
      retry-policy class of failure.

    Writes (``put_bytes``/``register``) pass through un-faulted unless
    ``fail_next`` is armed: the interesting spill-side faults are crash
    faults (SIGKILL mid-demote), which the chaos tests inject by killing
    the engine, not the store."""

    def __init__(self, inner):
        self.inner = inner
        self._lock = threading.Lock()
        self._fail_remaining = 0
        self._truncate_remaining = 0
        self._wedged = threading.Event()
        self._release = threading.Event()
        self.stats = {"wedged_reads": 0, "truncated_reads": 0,
                      "injected_errors": 0}

    def wedge_promote(self) -> None:
        self._release.clear()
        self._wedged.set()

    def unwedge(self) -> None:
        self._wedged.clear()
        self._release.set()

    def truncate_next(self, n: int = 1) -> None:
        with self._lock:
            self._truncate_remaining = int(n)

    def fail_next(self, n: int = 1) -> None:
        with self._lock:
            self._fail_remaining = int(n)

    def _maybe_fail(self) -> None:
        with self._lock:
            if self._fail_remaining > 0:
                self._fail_remaining -= 1
                self.stats["injected_errors"] += 1
                raise OSError("chaos: injected store fault")

    def _maybe_wedge(self) -> None:
        if self._wedged.is_set():
            self.stats["wedged_reads"] += 1
            self._release.wait()   # the wedge: held until unwedge()

    # -- the ArtifactStore surface the KV tier drives -----------------------

    def lookup(self, name: str, version: Optional[str] = None) -> str:
        self._maybe_fail()
        self._maybe_wedge()
        return self.inner.lookup(name, version)

    def get_bytes(self, uri: str) -> bytes:
        self._maybe_fail()
        self._maybe_wedge()
        data = self.inner.get_bytes(uri)
        with self._lock:
            truncate = self._truncate_remaining > 0
            if truncate:
                self._truncate_remaining -= 1
                self.stats["truncated_reads"] += 1
        return data[:len(data) // 2] if truncate else data

    def put_bytes(self, data: bytes) -> str:
        self._maybe_fail()
        return self.inner.put_bytes(data)

    def register(self, name: str, version: str, uri: str) -> str:
        self._maybe_fail()
        return self.inner.register(name, version, uri)

    def __getattr__(self, item):
        # Anything else (GC sweeps, listing) hits the real store.
        return getattr(self.inner, item)


class ChaosProxy:
    """HTTP fault middleman: register ``proxy.url`` with the Router in
    place of the real replica URL, then turn fault knobs mid-traffic.

    Knobs (all safe to flip while serving):
    - ``fail_next(n, code)``: answer the next ``n`` requests with ``code``
      (5xx burst) without touching the target.
    - ``latency``: seconds added before every forwarded request.
    - ``wedge()`` / ``unwedge()``: accept connections but never answer
      (SIGSTOP analog at the HTTP layer) — held requests are released,
      with a closed connection, when unwedged or at ``stop()``.
    - ``drop()`` / ``undrop()``: close every new connection before any
      response byte — the router-visible shape of a dead process.
    - ``drop_response()`` / ``undrop_response()``: forward the request
      to the target, then close the connection WITHOUT relaying the
      response — the dropped-ACK fault: a handoff's receiver adopted the
      pages, but the sender never hears it (the ack-hold protocol's
      reason to exist).
    """

    def __init__(self, target: str, host: str = "127.0.0.1", port: int = 0):
        self.target = target.rstrip("/")
        self.latency = 0.0
        self.fail_code = 503
        self._fail_remaining = 0
        self._lock = threading.Lock()
        self._wedged = threading.Event()
        self._dropped = threading.Event()
        self._drop_response = threading.Event()
        self._release = threading.Event()   # set -> wedged requests exit
        self.stats = {"forwarded": 0, "injected_5xx": 0, "dropped": 0,
                      "wedged": 0, "responses_dropped": 0}
        self.httpd = ThreadingHTTPServer((host, port), _chaos_handler(self))
        self.httpd.daemon_threads = True
        quiet_handle_error(self.httpd)
        self.port = self.httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    @property
    def url(self) -> str:
        return f"http://127.0.0.1:{self.port}"

    def fail_next(self, n: int, code: int = 503) -> None:
        with self._lock:
            self._fail_remaining = int(n)
            self.fail_code = int(code)

    def wedge(self) -> None:
        self._release.clear()
        self._wedged.set()

    def unwedge(self) -> None:
        self._wedged.clear()
        self._release.set()

    def drop(self) -> None:
        self._dropped.set()

    def undrop(self) -> None:
        self._dropped.clear()

    def drop_response(self) -> None:
        self._drop_response.set()

    def undrop_response(self) -> None:
        self._drop_response.clear()

    def start(self) -> None:
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True, name="chaos-proxy")
        self._thread.start()

    def stop(self) -> None:
        self._release.set()      # free any wedged handler threads
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)


def _chaos_handler(proxy: ChaosProxy):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, *args) -> None:
            pass

        def _chaos(self) -> None:
            if proxy._dropped.is_set():
                # Zero response bytes: the caller sees a connection-level
                # failure (the retry-safe class).
                proxy.stats["dropped"] += 1
                self.close_connection = True
                try:
                    self.connection.close()
                except OSError:
                    pass
                return
            if proxy._wedged.is_set():
                proxy.stats["wedged"] += 1
                proxy._release.wait()        # the wedge: held until unwedged/stopped
                self.close_connection = True
                try:
                    self.connection.close()
                except OSError:
                    pass
                return
            if proxy.latency > 0:
                time.sleep(proxy.latency)
            with proxy._lock:
                inject = proxy._fail_remaining > 0
                if inject:
                    proxy._fail_remaining -= 1
                code = proxy.fail_code
            if inject:
                proxy.stats["injected_5xx"] += 1
                data = json.dumps({"error": "chaos: injected fault"}).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)
                return
            # Forward verbatim. The forward-list is DERIVED from the
            # platform header module, not re-typed here: a new serving-path
            # header (deadline, QoS, trace, whatever comes next) rides
            # through the chaos middlebox the day it is added to
            # core/headers.FORWARD_HEADERS.
            n = int(self.headers.get("Content-Length", 0))
            body = self.rfile.read(n) if n else None
            fwd_headers = {"Content-Type": self.headers.get(
                "Content-Type", "application/json")}
            for h in FORWARD_HEADERS:
                if self.headers.get(h):
                    fwd_headers[h] = self.headers[h]
                    contract_note_header(h, direction="set")
            req = urllib.request.Request(
                proxy.target + self.path, data=body, method=self.command,
                headers=fwd_headers)
            try:
                with urllib.request.urlopen(req, timeout=600) as resp:
                    data = resp.read()
                    status, ctype = resp.status, resp.headers.get(
                        "Content-Type", "application/json")
            except urllib.error.HTTPError as exc:
                data = exc.read()
                status, ctype = exc.code, "application/json"
            except OSError:
                self.close_connection = True
                try:
                    self.connection.close()
                except OSError:
                    pass
                return
            proxy.stats["forwarded"] += 1
            if proxy._drop_response.is_set():
                # The target fully processed the request (a handoff
                # receiver has ADOPTED the pages by now) — the caller
                # just never hears the ack. Distinct from drop(): that
                # fails before any byte reaches the target.
                proxy.stats["responses_dropped"] += 1
                self.close_connection = True
                try:
                    self.connection.close()
                except OSError:
                    pass
                return
            self.send_response(status)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        do_GET = _chaos
        do_POST = _chaos

    return Handler
