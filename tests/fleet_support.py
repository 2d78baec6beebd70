"""Shared helpers of the port's fleet and chaos tests (``test_torch_fleet``,
``test_torch_chaos``): HTTP clients that always resolve to an explicit
status, the closed-loop client pool, and the post-scenario refcount
audit."""

import json
import socket
import threading
import time
import urllib.error
import urllib.request

from kubeflow_tpu_torch.core.headers import DEADLINE_HEADER, QOS_HEADER

#: Every status a request through the fleet may end with: anything else
#: (or a hang) is a failure of the fleet.
EXPLICIT_STATUSES = {200, 429, 500, 502, 503, 504}


def dead_url() -> str:
    """A URL nothing listens on: bound then closed, so a connect fails
    fast with ECONNREFUSED (the dead-replica fault)."""
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return f"http://127.0.0.1:{port}"


def completion_text(url: str, prompt: str, *, headers=(), max_tokens: int = 8,
                    timeout_s: float = 20.0) -> tuple[int, str]:
    """(status, completion text or error body) of one ``/v1/completions``."""
    body = json.dumps({"prompt": prompt, "max_tokens": max_tokens,
                       "timeout": timeout_s}).encode()
    hdrs = {"Content-Type": "application/json", **dict(headers)}
    req = urllib.request.Request(url + "/v1/completions", data=body,
                                 headers=hdrs)
    try:
        with urllib.request.urlopen(req, timeout=timeout_s + 5) as r:
            return r.status, json.loads(r.read())["choices"][0]["text"]
    except urllib.error.HTTPError as exc:
        return exc.code, exc.read().decode(errors="replace")


def completion(url: str, *, timeout_s: float = 10.0, max_tokens: int = 8,
               prompt: str = "chaos", qos: str = "") -> int:
    """The status of one completion with a deadline header; a
    connection-level failure is an explicit 502, never a hang."""
    headers = {DEADLINE_HEADER: str(int(timeout_s * 1e3))}
    if qos:
        headers[QOS_HEADER] = qos
    try:
        return completion_text(url, prompt, headers=headers.items(),
                               max_tokens=max_tokens, timeout_s=timeout_s)[0]
    except OSError:
        return 502


def fire(url: str, n: int, concurrency: int = 4, *,
         mid_fault=None, fault_after: int = 2, **kw) -> list[int]:
    """Closed-loop client pool; optionally calls ``mid_fault()`` once
    ``fault_after`` requests have completed. Asserts the no-hang bound."""
    results: list[int] = []
    lock = threading.Lock()
    it = iter(range(n))
    fault_fired = threading.Event()

    def client():
        while True:
            with lock:
                nxt = next(it, None)
            if nxt is None:
                return
            status = completion(url, **kw)
            with lock:
                results.append(status)
                if (mid_fault is not None and not fault_fired.is_set()
                        and len(results) >= fault_after):
                    fault_fired.set()
                    mid_fault()

    threads = [threading.Thread(target=client)
               for _ in range(max(1, concurrency))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=90.0)
        assert not t.is_alive(), "client thread hung (no-hang invariant)"
    assert len(results) == n
    return results


def audit_quiescent(*servers, deadline_s: float = 20.0) -> None:
    """Post-scenario refcount audit: cancel anything stranded (the
    operator's analog of process teardown, handoff holds included), let the
    reaper run — the engine's own loop where it still runs, ``step()`` by
    hand where the server was killed — and assert zero page leaks and no
    decode round left in flight."""
    for srv in servers:
        eng = srv.engine
        for s in eng.slots:
            if s is not None:
                s.request.cancel()
        for lane in (eng._backlog, eng._preempted):
            for req in list(lane):
                req.cancel()
        for ch in list(eng._chunkings):
            ch.request.cancel()
        for hreq, _pages in list(eng._handoff_holds.values()):
            hreq.cancel()
        deadline = time.monotonic() + deadline_s
        while eng.kv_pages_in_use() > 0 or eng._handoff_holds or eng._rounds:
            if not eng._stop.is_set():
                eng._wake.set()
                time.sleep(0.01)
            else:
                if eng._thread is not None:
                    eng._thread.join(timeout=10.0)   # the halted loop's end
                eng.step()
            assert time.monotonic() < deadline, \
                f"{srv.name}: KV pages leaked after scenario"
        eng._allocator.assert_quiescent()


def stop_all(*servers) -> None:
    for s in servers:
        try:
            s.stop()
        except OSError:
            pass
