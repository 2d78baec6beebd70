"""Declarative serving-traffic scenarios and the deterministic schedule
builder (a copy of ``kubeflow_tpu/loadgen/scenario.py``; numpy only, the
QoS classes from the port's ``core/serving.py``).

A ``Scenario`` declares OPEN-LOOP offered traffic: requests land on a
clock the server does not control, bursts queue instead of politely
waiting, and latency percentiles under a given offered rate are the SLO
currency. It names:

- **arrival process** (``Arrival``): ``poisson`` (memoryless, the
  default fleet model), ``bursty`` (``burst_depth`` requests land
  together — the thundering-herd/queue-knee probe), ``ramp`` (rate
  climbs linearly across the run — the autoscaler-trigger shape), or
  ``uniform`` (fixed spacing — the lowest-variance baseline);
- **prompt/output length distributions** (``LengthDist``): fixed,
  uniform, lognormal (a long-tail mix), or an explicit choice set;
- **shared-prefix overlap** (``prefix_overlap``): the leading fraction
  of every prompt drawn from one scenario-wide token pool — the
  traffic property the paged prefix cache monetizes;
- **QoS-class mix** (``qos_mix``): per-class arrival weights, riding
  the ``X-Kftpu-Qos`` header end-to-end;
- **SLO** (``slo_ttft_ms``): the TTFT bound goodput is measured under.

``build_schedule`` expands a scenario into a concrete request list with
a SEEDED ``numpy`` RNG — same seed, same scenario → byte-identical
schedule (arrival times, prompts, QoS labels) to the JAX package's, so
an A/B or a regression gate replays the exact same traffic on both
sides."""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from kubeflow_tpu_torch.core.serving import QOS_DEFAULT, QOS_PRIORITY

ARRIVAL_PROCESSES = ("poisson", "bursty", "ramp", "uniform")
LENGTH_KINDS = ("fixed", "uniform", "lognormal", "choice")


@dataclasses.dataclass(frozen=True)
class Arrival:
    """Open-loop arrival process. ``rate_rps`` is the mean offered rate;
    ``bursty`` preserves it (bursts of ``burst_depth`` spaced
    ``burst_depth / rate_rps`` apart unless ``burst_gap_s`` overrides);
    ``ramp`` climbs from ``rate_rps`` to ``ramp_to_rps`` across the
    schedule."""

    process: str = "poisson"
    rate_rps: float = 8.0
    burst_depth: int = 8
    burst_gap_s: Optional[float] = None
    ramp_to_rps: Optional[float] = None

    def validate(self) -> None:
        if self.process not in ARRIVAL_PROCESSES:
            raise ValueError(f"unknown arrival process {self.process!r}; "
                             f"known: {ARRIVAL_PROCESSES}")
        if self.rate_rps <= 0:
            raise ValueError("rate_rps must be > 0")
        if self.process == "bursty" and self.burst_depth < 1:
            raise ValueError("burst_depth must be >= 1")
        if self.process == "ramp" and (self.ramp_to_rps is None
                                       or self.ramp_to_rps <= 0):
            raise ValueError("ramp needs ramp_to_rps > 0")


@dataclasses.dataclass(frozen=True)
class LengthDist:
    """Token-count distribution (prompt or output length). ``low``/
    ``high`` clip every kind, so a lognormal tail cannot exceed the
    engine's sequence budget."""

    kind: str = "fixed"
    value: int = 64                      # fixed
    low: int = 1
    high: int = 100_000
    mu: float = 5.3                      # lognormal (log-space mean)
    sigma: float = 0.8
    choices: tuple = ()                  # choice

    def validate(self) -> None:
        if self.kind not in LENGTH_KINDS:
            raise ValueError(f"unknown length kind {self.kind!r}; "
                             f"known: {LENGTH_KINDS}")
        if self.kind == "choice" and not self.choices:
            raise ValueError("choice distribution needs choices")
        if self.low > self.high:
            raise ValueError("low > high")

    def sample(self, rng: np.random.Generator, cap: int) -> int:
        """One draw, clipped to [max(1, low), min(high, cap)]."""
        lo = max(1, self.low)
        hi = max(lo, min(self.high, cap))
        if self.kind == "fixed":
            raw = self.value
        elif self.kind == "uniform":
            raw = int(rng.integers(lo, hi + 1))
        elif self.kind == "lognormal":
            raw = int(rng.lognormal(self.mu, self.sigma))
        elif self.kind == "choice":
            raw = int(rng.choice(np.asarray(self.choices)))
        else:
            raise ValueError(self.kind)
        return int(min(max(raw, lo), hi))


@dataclasses.dataclass(frozen=True)
class Scenario:
    """One declarative traffic scenario (see module docstring)."""

    name: str
    num_requests: int = 32
    arrival: Arrival = dataclasses.field(default_factory=Arrival)
    prompt_len: LengthDist = dataclasses.field(
        default_factory=lambda: LengthDist(kind="fixed", value=48))
    output_len: LengthDist = dataclasses.field(
        default_factory=lambda: LengthDist(kind="fixed", value=16))
    #: Leading fraction of every prompt drawn from the scenario-wide
    #: shared pool (0 = fully unique prompts, 0.9 = 90% shared prefix).
    prefix_overlap: float = 0.0
    #: ``((class, weight), ...)``; empty = everything QOS_DEFAULT.
    qos_mix: tuple = ()
    #: Per-class length overrides: ``((class, prompt LengthDist,
    #: output LengthDist), ...)``. Lets one scenario correlate class
    #: with shape — e.g. ``mixed_interference``'s bursty long-prefill
    #: batch arrivals interleaved with short interactive decodes (the
    #: head-of-line-blocking probe disaggregation exists to fix).
    #: Classes absent here use the scenario-wide distributions.
    class_profiles: tuple = ()
    seed: int = 0
    #: TTFT bound (ms) goodput is measured under; None = no SLO.
    slo_ttft_ms: Optional[float] = 1000.0
    #: Mean time-per-output-token bound (ms) goodput additionally
    #: requires; None = TTFT-only. The decode-side SLO: a streaming
    #: request whose tokens stall behind co-resident prefill chunks
    #: misses this even when its TTFT was fine — the interference axis
    #: disaggregation removes.
    slo_tpot_ms: Optional[float] = None
    #: QoS classes the TTFT SLO applies to (the goodput denominator).
    #: Empty = every request. The platform's QoS model gives latency
    #: SLOs to the interactive/standard tiers while batch is a
    #: throughput class — a scenario mixing them scopes its goodput to
    #: the SLO-bearing traffic (``mixed_interference`` does).
    slo_classes: tuple = ()
    #: Client-side per-request give-up budget (seconds).
    request_timeout_s: float = 120.0
    #: Multi-tenant LoRA (serve/lora.py): model ids stamped per request
    #: (the ``X-Kftpu-Model`` header / ``"model"`` body field). Empty =
    #: base-model traffic. Non-empty draws each request's adapter from
    #: this tuple with a zipf-skewed popularity law: weight(i) ∝
    #: (i+1)^-adapter_skew over the tuple order, so adapter_ids[0] is
    #: the hottest tenant — the churn/residency shape multi-adapter
    #: serving must absorb. ``adapter_skew=0`` = uniform.
    adapter_ids: tuple = ()
    adapter_skew: float = 1.0
    #: Multi-turn sessions (> 1 switches to session mode): requests
    #: group into conversations of this many turns. Turn 0 carries a
    #: normal prompt; each later turn carries only its NEW tokens and
    #: fires ``think_time_s`` after the previous turn completes, with
    #: the runner composing prompt = previous prompt + previous ACTUAL
    #: output + new tokens — the conversation-re-arrival shape the
    #: tiered KV cache monetizes (think-time gaps long enough force
    #: device→host demotion between turns, the tier-lifecycle probe).
    turns: int = 1
    think_time_s: float = 0.0

    def validate(self) -> None:
        if self.num_requests < 1:
            raise ValueError("num_requests must be >= 1")
        if not 0.0 <= self.prefix_overlap <= 1.0:
            raise ValueError("prefix_overlap must be in [0, 1]")
        if self.turns < 1:
            raise ValueError("turns must be >= 1")
        if self.adapter_skew < 0:
            raise ValueError("adapter_skew must be >= 0")
        if len(set(self.adapter_ids)) != len(self.adapter_ids):
            raise ValueError("adapter_ids must be unique")
        if self.think_time_s < 0:
            raise ValueError("think_time_s must be >= 0")
        self.arrival.validate()
        self.prompt_len.validate()
        self.output_len.validate()
        total = 0.0
        for cls, weight in self.qos_mix:
            if cls not in QOS_PRIORITY:
                raise ValueError(f"unknown QoS class {cls!r} in qos_mix; "
                                 f"known: {sorted(QOS_PRIORITY)}")
            if weight < 0:
                raise ValueError("qos_mix weights must be >= 0")
            total += weight
        if self.qos_mix and total <= 0:
            raise ValueError("qos_mix weights sum to 0")
        for cls in self.slo_classes:
            if cls not in QOS_PRIORITY:
                raise ValueError(
                    f"unknown QoS class {cls!r} in slo_classes; "
                    f"known: {sorted(QOS_PRIORITY)}")
        for entry in self.class_profiles:
            if len(entry) != 3:
                raise ValueError(
                    "class_profiles entries are (class, prompt LengthDist, "
                    "output LengthDist)")
            cls, pdist, odist = entry
            if cls not in QOS_PRIORITY:
                raise ValueError(
                    f"unknown QoS class {cls!r} in class_profiles; "
                    f"known: {sorted(QOS_PRIORITY)}")
            pdist.validate()
            odist.validate()


@dataclasses.dataclass(frozen=True)
class ScheduledRequest:
    """One concrete request in a built schedule: fire at ``t`` seconds
    after the run starts. Session mode (``Scenario.turns > 1``):
    ``prev_idx`` names the previous turn whose resolved prompt + actual
    output prefix this request's prompt (``prompt_tokens`` then carries
    only the NEW turn's tokens), and the runner fires it ``think_s``
    after that turn completes."""

    idx: int
    t: float
    prompt_tokens: tuple
    max_new_tokens: int
    qos: str
    session: int = -1
    turn: int = 0
    prev_idx: Optional[int] = None
    think_s: float = 0.0
    #: Model id this request targets (None = base model).
    adapter: Optional[str] = None


def _adapter_draw(scenario: Scenario,
                  rng: np.random.Generator) -> Optional[str]:
    """One zipf-skewed adapter draw (None when the scenario carries no
    adapter mix). Drawn LAST per request/session so adapter-free
    scenarios keep their historical byte-identical schedules."""
    if not scenario.adapter_ids:
        return None
    ranks = np.arange(1, len(scenario.adapter_ids) + 1, dtype=float)
    w = ranks ** -scenario.adapter_skew
    w = w / w.sum()
    return str(rng.choice(np.asarray(scenario.adapter_ids, object), p=w))


def arrival_times(arrival: Arrival, n: int,
                  rng: np.random.Generator) -> list[float]:
    """``n`` non-decreasing arrival offsets (seconds from run start)."""
    arrival.validate()
    rate = arrival.rate_rps
    if arrival.process == "uniform":
        return [i / rate for i in range(n)]
    if arrival.process == "poisson":
        gaps = rng.exponential(1.0 / rate, size=n)
        gaps[0] = 0.0                    # first arrival starts the clock
        return np.cumsum(gaps).tolist()
    if arrival.process == "bursty":
        depth = arrival.burst_depth
        gap = (arrival.burst_gap_s if arrival.burst_gap_s is not None
               else depth / rate)
        return [(i // depth) * gap for i in range(n)]
    # ramp: per-arrival rate climbs linearly rate → ramp_to_rps.
    out: list[float] = []
    t = 0.0
    for i in range(n):
        frac = i / max(n - 1, 1)
        r = rate + (arrival.ramp_to_rps - rate) * frac
        out.append(t)
        t += float(rng.exponential(1.0 / r))
    return out


def build_schedule(scenario: Scenario, *, vocab_size: int,
                   max_prompt_len: int) -> list[ScheduledRequest]:
    """Expand a scenario into its concrete, deterministic request list.

    One seeded RNG drives everything in a FIXED draw order (arrivals,
    then per-request lengths/tokens/class), so equal (scenario, vocab,
    cap) inputs produce identical schedules — the property the perf
    gate's replay and the determinism tests pin."""
    scenario.validate()
    if vocab_size < 2:
        raise ValueError("vocab_size must be >= 2")
    if max_prompt_len < 1:
        raise ValueError("max_prompt_len must be >= 1")
    rng = np.random.default_rng(scenario.seed)
    if scenario.turns > 1:
        return _build_session_schedule(scenario, rng,
                                       vocab_size=vocab_size,
                                       max_prompt_len=max_prompt_len)
    times = arrival_times(scenario.arrival, scenario.num_requests, rng)
    # The shared pool every prompt's prefix comes from: drawn once per
    # scenario, so overlapping prompts share ACTUAL token content (the
    # thing a prefix cache can hit on), not just a length statistic.
    shared = rng.integers(1, vocab_size, size=max_prompt_len)
    classes = [cls for cls, _ in scenario.qos_mix] or [QOS_DEFAULT]
    weights = np.asarray([w for _, w in scenario.qos_mix] or [1.0], float)
    weights = weights / weights.sum()
    profiles = {cls: (pd, od) for cls, pd, od in scenario.class_profiles}
    out: list[ScheduledRequest] = []
    for i in range(scenario.num_requests):
        if profiles:
            # Class-correlated shapes: the class draw moves FIRST so it
            # can select the distributions. Profile-free scenarios keep
            # the historical draw order (byte-identical schedules).
            qos = str(rng.choice(classes, p=weights))
            pdist, odist = profiles.get(
                qos, (scenario.prompt_len, scenario.output_len))
            plen = pdist.sample(rng, max_prompt_len)
            k = int(round(scenario.prefix_overlap * plen))
            tail = rng.integers(1, vocab_size, size=plen - k)
            prompt = tuple(int(x) for x in shared[:k]) \
                + tuple(int(x) for x in tail)
            out.append(ScheduledRequest(
                idx=i, t=float(times[i]), prompt_tokens=prompt,
                max_new_tokens=odist.sample(rng, 100_000), qos=qos,
                adapter=_adapter_draw(scenario, rng)))
            continue
        plen = scenario.prompt_len.sample(rng, max_prompt_len)
        k = int(round(scenario.prefix_overlap * plen))
        tail = rng.integers(1, vocab_size, size=plen - k)
        prompt = tuple(int(x) for x in shared[:k]) \
            + tuple(int(x) for x in tail)
        out.append(ScheduledRequest(
            idx=i, t=float(times[i]), prompt_tokens=prompt,
            max_new_tokens=scenario.output_len.sample(rng, 100_000),
            qos=str(rng.choice(classes, p=weights)),
            adapter=_adapter_draw(scenario, rng)))
    return out


def _build_session_schedule(scenario: Scenario, rng: np.random.Generator,
                            *, vocab_size: int,
                            max_prompt_len: int) -> list[ScheduledRequest]:
    """Session-mode expansion (``turns > 1``): the arrival process
    places SESSION starts; each session is ``turns`` chained requests.
    Turn 0 draws a normal (possibly shared-prefix) prompt; later turns
    draw only their new tokens — the runner prepends the conversation
    so far (previous resolved prompt + ACTUAL generated output). One
    QoS class per session (a conversation does not change tenants
    mid-flight). Same seed → byte-identical schedule, like the flat
    path — only the composed prompts depend on runtime outputs."""
    turns = scenario.turns
    think = scenario.think_time_s
    n_sessions = max(1, scenario.num_requests // turns)
    times = arrival_times(scenario.arrival, n_sessions, rng)
    shared = rng.integers(1, vocab_size, size=max_prompt_len)
    classes = [cls for cls, _ in scenario.qos_mix] or [QOS_DEFAULT]
    weights = np.asarray([w for _, w in scenario.qos_mix] or [1.0], float)
    weights = weights / weights.sum()
    out: list[ScheduledRequest] = []
    idx = 0
    for s_i in range(n_sessions):
        qos = str(rng.choice(classes, p=weights))
        adapter = _adapter_draw(scenario, rng)
        for t_i in range(turns):
            if t_i == 0:
                plen = scenario.prompt_len.sample(rng, max_prompt_len)
                k = int(round(scenario.prefix_overlap * plen))
                tail = rng.integers(1, vocab_size, size=plen - k)
                prompt = tuple(int(x) for x in shared[:k]) \
                    + tuple(int(x) for x in tail)
            else:
                # A new turn is SHORT relative to the history it rides
                # on — a quarter of the opening-prompt distribution.
                plen = max(1, scenario.prompt_len.sample(
                    rng, max_prompt_len) // 4)
                prompt = tuple(int(x) for x in
                               rng.integers(1, vocab_size, size=plen))
            out.append(ScheduledRequest(
                idx=idx, t=float(times[s_i]) + t_i * think,
                prompt_tokens=prompt,
                max_new_tokens=scenario.output_len.sample(rng, 100_000),
                qos=qos, session=s_i, turn=t_i,
                prev_idx=(idx - 1 if t_i else None),
                think_s=(think if t_i else 0.0), adapter=adapter))
            idx += 1
    return out


def standard_matrix(*, num_requests: int = 24, rate_rps: float = 8.0,
                    prompt_len: int = 48, max_new: int = 16,
                    slo_ttft_ms: float = 2000.0,
                    mixed_slo_tpot_ms: Optional[float] = None,
                    shared_prefix_overlap: float = 0.75,
                    multi_turn_think_s: float = 0.35,
                    adapter_ids: tuple = ("adpt-0", "adpt-1", "adpt-2",
                                          "adpt-3"),
                    adapter_skew: float = 1.0,
                    seed: int = 0) -> list[Scenario]:
    """The canonical 6-scenario serving matrix the perf gate and
    ``bench_serve.py --workload scenarios`` both replay:

    - ``uniform`` — Poisson arrivals, fixed lengths, one QoS class: the
      steady-state baseline every regression is easiest to read on;
    - ``bursty_qos`` — burst arrivals with a mixed interactive/batch
      class split: exercises admission, shed ordering, and cross-class
      preemption (the per-class attribution rows);
    - ``shared_prefix`` — Poisson arrivals with 75% shared-prefix
      prompts and a long-tail length mix: the prefix-cache/paged-pool
      regime (ROADMAP item 1's success metric runs through this shape);
    - ``mixed_interference`` — bursty long-prefill batch arrivals
      interleaved with short interactive requests (class-correlated
      shapes via ``class_profiles``): makes prefill→decode head-of-line
      blocking measurable — the disaggregated prefill/decode split
      proves its goodput win through this shape (ROADMAP item 2);
    - ``multi_turn`` — conversation sessions re-arriving with their
      prior prefix plus one new turn, think-time gaps between turns
      (long enough to force tier demotion when the host tier is on):
      the tiered-KV-cache regime — prefix reuse across slot release,
      COW tails, and the device↔host migration lifecycle
      (``scripts/prefix_cache_smoke.py`` gates through this shape).

    - ``multi_adapter`` — Poisson arrivals with every request stamped a
      model id drawn zipf-skewed from ``adapter_ids`` (a few hot
      tenants, a long cold tail): the multi-tenant LoRA regime —
      batched multi-adapter decode, hot-load/evict churn, and model-id
      routing prove their degradation bounds through this shape
      (``scripts/lora_smoke.py`` gates it; ROADMAP item 4).

    ``shared_prefix_overlap`` sweeps the shared-prefix scenario's
    overlap fraction (the 0.5–0.95 axis the prefix-cache gate walks);
    ``adapter_ids``/``adapter_skew`` parameterize the multi_adapter
    mix (the 8/32/64-concurrent-adapter axis the LoRA gate walks).
    """
    return [
        Scenario(
            name="uniform", num_requests=num_requests, seed=seed,
            arrival=Arrival(process="poisson", rate_rps=rate_rps),
            prompt_len=LengthDist(kind="fixed", value=prompt_len),
            output_len=LengthDist(kind="fixed", value=max_new),
            slo_ttft_ms=slo_ttft_ms),
        Scenario(
            name="bursty_qos", num_requests=num_requests, seed=seed + 1,
            arrival=Arrival(process="bursty", rate_rps=rate_rps,
                            burst_depth=max(4, num_requests // 4)),
            prompt_len=LengthDist(kind="uniform", low=max(8, prompt_len // 4),
                                  high=prompt_len),
            output_len=LengthDist(kind="fixed", value=max_new),
            qos_mix=(("interactive", 0.5), ("batch", 0.5)),
            slo_ttft_ms=slo_ttft_ms),
        Scenario(
            name="shared_prefix", num_requests=num_requests, seed=seed + 2,
            arrival=Arrival(process="poisson", rate_rps=rate_rps),
            prompt_len=LengthDist(kind="lognormal",
                                  mu=float(np.log(max(prompt_len, 2))),
                                  sigma=0.4, low=max(8, prompt_len // 4),
                                  high=2 * prompt_len),
            output_len=LengthDist(kind="fixed", value=max_new),
            prefix_overlap=shared_prefix_overlap,
            slo_ttft_ms=slo_ttft_ms),
        Scenario(
            name="mixed_interference", num_requests=num_requests,
            seed=seed + 3,
            arrival=Arrival(process="bursty", rate_rps=rate_rps,
                            burst_depth=max(4, num_requests // 6)),
            prompt_len=LengthDist(kind="fixed", value=prompt_len),
            output_len=LengthDist(kind="fixed", value=max_new),
            qos_mix=(("interactive", 0.75), ("batch", 0.25)),
            class_profiles=(
                ("interactive",
                 LengthDist(kind="fixed", value=max(8, prompt_len // 4)),
                 LengthDist(kind="fixed", value=max_new)),
                ("batch",
                 LengthDist(kind="fixed", value=4 * prompt_len),
                 LengthDist(kind="fixed", value=max(2, max_new // 2))),
            ),
            slo_ttft_ms=slo_ttft_ms, slo_tpot_ms=mixed_slo_tpot_ms,
            slo_classes=("interactive",)),
        Scenario(
            name="multi_adapter", num_requests=num_requests, seed=seed + 5,
            arrival=Arrival(process="poisson", rate_rps=rate_rps),
            prompt_len=LengthDist(kind="fixed", value=prompt_len),
            output_len=LengthDist(kind="fixed", value=max_new),
            adapter_ids=tuple(adapter_ids), adapter_skew=adapter_skew,
            slo_ttft_ms=slo_ttft_ms),
        Scenario(
            name="multi_turn", num_requests=num_requests, seed=seed + 4,
            # Sessions arrive slower than single-shot requests — each
            # one carries `turns` requests of offered load.
            arrival=Arrival(process="poisson",
                            rate_rps=max(rate_rps / 3.0, 0.5)),
            prompt_len=LengthDist(kind="fixed", value=prompt_len),
            output_len=LengthDist(kind="fixed", value=max_new),
            turns=3, think_time_s=multi_turn_think_s,
            prefix_overlap=0.5, slo_ttft_ms=slo_ttft_ms),
    ]


def measured_prefix_overlap(prompts: Sequence[Sequence[int]]) -> float:
    """Mean shared-prefix fraction over consecutive prompt pairs:
    ``lcp(p_i, p_{i+1}) / min(len_i, len_{i+1})`` — the check that the
    generated traffic actually HAS the overlap the scenario declared
    (for ``prefix_overlap=f`` and immediately-diverging tails this
    measures ≈ f)."""
    if len(prompts) < 2:
        return 0.0
    fracs = []
    for a, b in zip(prompts, prompts[1:]):
        n = min(len(a), len(b))
        if n == 0:
            continue
        lcp = 0
        while lcp < n and a[lcp] == b[lcp]:
            lcp += 1
        fracs.append(lcp / n)
    return sum(fracs) / max(len(fracs), 1)
