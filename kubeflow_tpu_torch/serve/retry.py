"""Retry and backoff policy for the KV handoff and the KV tiers — a copy of
``kubeflow_tpu/serve/retry.py`` (the port imports nothing of the JAX
package). Every caller states its failure budget as data: bounded
attempts, exponential backoff, a jitter band so replicas retrying the same
dead peer do not retry in lockstep, and a hard cap.

Timeout knobs (read once per call site):

- ``KFTPU_HANDOFF_CONNECT_S``: TCP connect + request-send budget of a
  handoff POST.
- ``KFTPU_HANDOFF_ACK_S``: how long the prefill side holds its pages
  waiting for the decode side's ack before it treats the peer as dead.
- ``KFTPU_HANDOFF_RETRIES``: further decode replicas to try after the
  first handoff target fails (each attempt goes to a different replica;
  when all fail, the prefill side recomputes locally).

The router's scrape probe policy of the JAX module belongs to the router,
which the port does not have yet.
"""

from __future__ import annotations

import os
import random
import time
from dataclasses import dataclass
from typing import Callable, Optional


def env_float(name: str, default: float) -> float:
    """One knob read: an unparseable value falls back to the default
    instead of crashing a serving replica."""
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


def env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


@dataclass(frozen=True)
class RetryPolicy:
    """Jittered exponential backoff with bounded attempts.

    ``attempts`` is the TOTAL number of tries (the first included);
    ``base_s`` the backoff before the second try; each further backoff
    doubles, capped at ``cap_s``; ``jitter_frac`` widens every delay to a
    uniform band ``[d*(1-j), d*(1+j)]`` (still capped)."""

    attempts: int = 3
    base_s: float = 0.05
    cap_s: float = 2.0
    jitter_frac: float = 0.5

    def delay_s(self, failures: int,
                rng: Optional[random.Random] = None) -> float:
        """Backoff to sleep after the ``failures``-th failure (1-based: the
        delay between try N and try N+1 has ``failures == N``)."""
        if failures <= 0:
            return 0.0
        d = min(self.base_s * (2.0 ** (failures - 1)), self.cap_s)
        j = max(0.0, min(float(self.jitter_frac), 1.0))
        if j:
            r = (rng or random).uniform(1.0 - j, 1.0 + j)
            d *= r
        return min(d, self.cap_s)

    def delays(self, rng: Optional[random.Random] = None) -> list[float]:
        """Every backoff this policy sleeps, in order (``attempts - 1`` of
        them)."""
        return [self.delay_s(i, rng) for i in range(1, self.attempts)]


def call_with_retry(fn: Callable, *, policy: RetryPolicy,
                    retry_on: tuple = (OSError,),
                    on_retry: Optional[Callable] = None,
                    sleep: Callable[[float], None] = time.sleep,
                    rng: Optional[random.Random] = None):
    """Run ``fn(attempt)`` under ``policy``. ``fn`` receives the 0-based
    attempt index, so a caller can aim each attempt at a different peer.
    Exhausted attempts re-raise the LAST exception: giving up is the
    caller's signal to take its terminal fallback (recompute)."""
    last: Optional[BaseException] = None
    for attempt in range(max(1, policy.attempts)):
        if attempt:
            if on_retry is not None:
                on_retry(attempt, last)
            sleep(policy.delay_s(attempt, rng))
        try:
            return fn(attempt)
        except retry_on as exc:
            last = exc
    assert last is not None
    raise last


def handoff_policy() -> RetryPolicy:
    """The handoff POST's budget: each attempt targets a different decode
    replica, so attempts = 1 + ``KFTPU_HANDOFF_RETRIES``."""
    return RetryPolicy(attempts=1 + max(0, env_int("KFTPU_HANDOFF_RETRIES",
                                                   2)),
                       base_s=0.05, cap_s=1.0, jitter_frac=0.5)


#: Store I/O of the KV tiers: a small budget, since a promotion's own
#: deadline bounds the whole operation.
STORE_POLICY = RetryPolicy(attempts=2, base_s=0.02, cap_s=0.2,
                           jitter_frac=0.5)
