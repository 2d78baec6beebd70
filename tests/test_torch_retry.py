"""The port's retry policy (``kubeflow_tpu_torch/serve/retry.py``), held to
``tests/test_serve_retry.py``'s cases and to the JAX package's policy: the
jitter band, exponential growth, the hard cap, giving up, the call
contract (0-based attempt index, the last exception re-raised) and the
knobs. A seeded ``random.Random`` must draw the same delays from both
packages' policies."""

import random

import pytest

from kubeflow_tpu_torch.serve.retry import (
    STORE_POLICY, RetryPolicy, call_with_retry, env_float, env_int,
    handoff_policy,
)
from port_threads import torch_on_one_thread  # noqa: F401


class TestRetryPolicy:
    def test_delays_length_is_attempts_minus_one(self):
        p = RetryPolicy(attempts=4, base_s=0.1, cap_s=10.0, jitter_frac=0.0)
        assert p.delays() == [0.1, 0.2, 0.4]

    def test_jitter_band_bounds(self):
        p = RetryPolicy(attempts=3, base_s=0.1, cap_s=10.0, jitter_frac=0.5)
        rng = random.Random(7)
        for _ in range(500):
            d1 = p.delay_s(1, rng)
            d2 = p.delay_s(2, rng)
            assert 0.05 <= d1 <= 0.15, d1
            assert 0.10 <= d2 <= 0.30, d2

    def test_jitter_actually_desynchronizes(self):
        p = RetryPolicy(attempts=2, base_s=0.1, cap_s=1.0, jitter_frac=0.5)
        rng = random.Random(3)
        assert len({p.delay_s(1, rng) for _ in range(50)}) > 10

    def test_cap_applies_even_with_jitter(self):
        p = RetryPolicy(attempts=10, base_s=1.0, cap_s=2.0, jitter_frac=0.9)
        rng = random.Random(11)
        for failures in range(1, 10):
            for _ in range(100):
                assert p.delay_s(failures, rng) <= 2.0

    def test_zero_failures_means_zero_delay(self):
        assert RetryPolicy().delay_s(0) == 0.0


class TestCallWithRetry:
    def test_passes_attempt_index_and_succeeds(self):
        seen = []

        def fn(attempt):
            seen.append(attempt)
            if attempt < 2:
                raise OSError("down")
            return "ok"

        p = RetryPolicy(attempts=3, base_s=0.0, jitter_frac=0.0)
        assert call_with_retry(fn, policy=p, sleep=lambda s: None) == "ok"
        assert seen == [0, 1, 2]

    def test_exhaustion_reraises_last_exception(self):
        def fn(attempt):
            raise OSError(f"fail {attempt}")

        p = RetryPolicy(attempts=3, base_s=0.0, jitter_frac=0.0)
        with pytest.raises(OSError, match="fail 2"):
            call_with_retry(fn, policy=p, sleep=lambda s: None)

    def test_non_retryable_exception_propagates_immediately(self):
        calls = []

        def fn(attempt):
            calls.append(attempt)
            raise ValueError("not transient")

        p = RetryPolicy(attempts=5, base_s=0.0, jitter_frac=0.0)
        with pytest.raises(ValueError):
            call_with_retry(fn, policy=p, sleep=lambda s: None)
        assert calls == [0]

    def test_on_retry_fires_between_attempts_with_last_exc(self):
        notes = []

        def fn(attempt):
            raise OSError("x")

        p = RetryPolicy(attempts=3, base_s=0.0, jitter_frac=0.0)
        with pytest.raises(OSError):
            call_with_retry(fn, policy=p, sleep=lambda s: None,
                            on_retry=lambda a, e: notes.append((a, str(e))))
        assert notes == [(1, "x"), (2, "x")]

    def test_sleeps_follow_the_policy(self):
        slept = []

        def fn(attempt):
            raise OSError("x")

        p = RetryPolicy(attempts=3, base_s=0.1, cap_s=10.0, jitter_frac=0.0)
        with pytest.raises(OSError):
            call_with_retry(fn, policy=p, sleep=slept.append)
        assert slept == [0.1, 0.2]


class TestEnvKnobs:
    def test_handoff_policy_reads_retry_knob(self, monkeypatch):
        monkeypatch.setenv("KFTPU_HANDOFF_RETRIES", "4")
        assert handoff_policy().attempts == 5
        monkeypatch.setenv("KFTPU_HANDOFF_RETRIES", "0")
        assert handoff_policy().attempts == 1   # never zero tries
        monkeypatch.delenv("KFTPU_HANDOFF_RETRIES")
        assert handoff_policy().attempts == 3   # default: 2 retries

    def test_env_parsers_fall_back_on_garbage(self, monkeypatch):
        monkeypatch.setenv("KFTPU_TEST_KNOB", "not-a-number")
        assert env_float("KFTPU_TEST_KNOB", 1.5) == 1.5
        assert env_int("KFTPU_TEST_KNOB", 7) == 7
        monkeypatch.setenv("KFTPU_TEST_KNOB", "2.5")
        assert env_float("KFTPU_TEST_KNOB", 1.5) == 2.5

    def test_shared_policies_are_bounded(self):
        """The store budget stays tiny: it sits on a latency path that its
        own deadline must dominate."""
        assert STORE_POLICY.attempts <= 3
        assert max(STORE_POLICY.delays(random.Random(0))) \
            <= STORE_POLICY.cap_s <= 0.5


def test_delays_equal_the_jax_policy(monkeypatch):
    """The same seeded generator gives the same delays from both packages,
    for the copied policies and for explicit ones."""
    jretry = pytest.importorskip("kubeflow_tpu.serve.retry")
    monkeypatch.setenv("KFTPU_HANDOFF_RETRIES", "5")
    pairs = [(handoff_policy(), jretry.handoff_policy()),
             (STORE_POLICY, jretry.STORE_POLICY)]
    for kw in (dict(attempts=6, base_s=0.05, cap_s=1.0, jitter_frac=0.5),
               dict(attempts=4, base_s=0.3, cap_s=0.5, jitter_frac=0.9),
               dict(attempts=3, base_s=0.1, cap_s=2.0, jitter_frac=0.0)):
        pairs.append((RetryPolicy(**kw), jretry.RetryPolicy(**kw)))
    for seed in (0, 1, 17):
        for mine, theirs in pairs:
            assert mine == RetryPolicy(**vars(theirs))
            assert mine.delays(random.Random(seed)) == \
                theirs.delays(random.Random(seed))
