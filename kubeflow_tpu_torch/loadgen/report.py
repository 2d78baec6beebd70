"""Per-scenario attribution reports: WHERE the latency went (a copy of
``kubeflow_tpu/loadgen/report.py`` over the port's ``obs`` modules, less
the fleet-stitched hop breakdown: the port has no fleet trace collector).

A bare "req/s moved" row is unactionable at fleet scale. Each scenario
report joins three views of the same run, so a regression names its
layer instead of just its magnitude:

1. **client-observed** — req/s, TTFT/TPOT p50/p95/p99, goodput under
   the scenario's TTFT SLO, per-QoS-class splits, and the generator's
   own schedule lag (an overloaded loadgen reports itself);
2. **engine-internal** — scraped from the REAL ``/metrics`` exposition
   through ``obs.registry.parse_exposition`` (the same grammar the SLO
   autoscaler scrapes through): queue-delay p95, host-gap percentiles,
   dispatch depth, shed/preemption counters, per-class attribution;
3. **per-request phase breakdown** — the engine's queued → prefill →
   decode span durations (``obs.trace.phase_durations``) aggregated to
   per-phase percentiles, for the traces the ring still holds.

Reading a regression: client TTFT p95 up + queue-delay p95 up + phases
showing ``queued_ms`` growth = admission backlog (add replicas / shed
earlier); TTFT up with queue-delay flat but ``prefill_ms`` up = prefill
path (bucket/chunking change); TPOT up with ``host_gap`` up = the host
loop re-serialized (pipelining regression).

``report_registry`` renders the client-side numbers as
``kftpu_loadgen_*`` series through the platform's one exposition path,
so a long-running loadgen is scrapeable like any other component.
"""

from __future__ import annotations

from typing import Optional

from kubeflow_tpu_torch.obs import stats
from kubeflow_tpu_torch.obs.registry import MetricsRegistry, parse_exposition
from kubeflow_tpu_torch.obs.trace import Tracer, get_tracer, phase_durations
from kubeflow_tpu_torch.loadgen.runner import ScenarioRun

#: Every engine-side series the attribution join consumes off the
#: /metrics exposition — the loadgen's half of the engine↔loadgen
#: metrics contract (the names ``serve/server.py`` renders, which are the
#: JAX package's).
ATTRIBUTION_SERIES = (
    "kftpu_serving_requests_total",
    "kftpu_serving_requests_shed_total",
    "kftpu_serving_preemptions_total",
    "kftpu_serving_queue_delay_p95_ms",
    "kftpu_serving_ttft_p95_ms",
    "kftpu_serving_host_gap_p50_ms",
    "kftpu_serving_host_gap_p99_ms",
    "kftpu_engine_dispatch_depth",
    "kftpu_serving_qos_requests_total",
    "kftpu_serving_qos_requests_shed_total",
    "kftpu_serving_qos_preemptions_total",
    "kftpu_serving_qos_ttft_p95_ms",
    "kftpu_serving_qos_queue_delay_p95_ms",
    # Tiered KV cache (serve/kvtier.py): the prefix-hit / COW /
    # device↔host migration attribution block — a shared-prefix or
    # multi-turn regression names the tier, not just the latency.
    "kftpu_engine_kv_pages_resident",
    "kftpu_engine_kv_pages_cached",
    "kftpu_engine_kv_pages_host",
    "kftpu_engine_kv_prefix_hits_total",
    "kftpu_engine_kv_prefix_tokens_reused_total",
    "kftpu_engine_kv_cow_copies_total",
    "kftpu_engine_kv_pages_demoted_total",
    "kftpu_engine_kv_pages_promoted_total",
    # Quantized KV fabric (ops/quantization.py kv path): pool dtype +
    # token density, and the wire bytes the handoff/tier paths actually
    # moved — an int8 regression names halved-wire-savings gone missing
    # (bytes back at full-dtype) or density collapsing to the bf16 pool.
    "kftpu_engine_kv_quant_enabled",
    "kftpu_engine_kv_quant_tokens_per_mib",
    "kftpu_engine_kv_handoff_bytes_exported_total",
    "kftpu_engine_kv_handoff_bytes_adopted_total",
    "kftpu_engine_kv_wire_bytes_demoted_total",
    "kftpu_engine_kv_wire_bytes_promoted_total",
    # Fleet-wide KV fabric: the remote third tier + the
    # cross-host handoff retry ladder. A wedged/slow store shows up as
    # promote timeouts with pages stuck remote; a torn blob as corrupt
    # rejections; a dying decode pool as handoffs retried then falling
    # back to local recompute — the gate names the faulted phase.
    "kftpu_engine_kv_pages_remote",
    "kftpu_engine_kv_remote_demoted_bytes_total",
    "kftpu_engine_kv_remote_promoted_bytes_total",
    "kftpu_engine_kv_remote_promote_timeouts_total",
    "kftpu_engine_kv_remote_blobs_corrupt_total",
    "kftpu_engine_kv_tier_pressure",
    "kftpu_engine_handoffs_retried_total",
    "kftpu_engine_handoffs_fallback_total",
    # Multi-tenant LoRA (serve/lora.py): adapter residency + hot-load/
    # evict lifecycle — a multi_adapter regression names adapter churn
    # (loads/evictions climbing) instead of just the latency.
    "kftpu_engine_adapters_resident",
    "kftpu_engine_adapter_loads_total",
    "kftpu_engine_adapter_evictions_total",
    # Fleet observability plane (obs/fleet.py): stitcher / history /
    # burn-rate health rendered through the same exposition grammar
    # (``fleet_obs_registry``). A run whose hop attribution looks thin
    # names its cause here — spans dropped at drain, skewed clocks, a
    # starved scrape loop — instead of reading as "the fleet was fast".
    "kftpu_fleet_spans_total",
    "kftpu_fleet_spans_duplicate_total",
    "kftpu_fleet_drain_errors_total",
    "kftpu_fleet_traces_stitched",
    "kftpu_fleet_clock_skew_ms",
    "kftpu_fleet_hops_total",
    "kftpu_fleet_hop_wire_ms",
    "kftpu_obs_history_points",
    "kftpu_obs_history_scrapes_total",
    "kftpu_obs_history_scrape_errors_total",
    "kftpu_obs_slo_burn_rate",
    "kftpu_obs_slo_alert",
    "kftpu_obs_flight_dumps_total",
)

#: Engine span-name prefix → report phase keys (obs.trace owns the
#: span names; phase_durations owns the extraction).
PHASE_KEYS = ("queued_ms", "adapter_load_ms", "kv_migrate_ms",
              "prefill_ms", "handoff_ms", "decode_ms")


def engine_attribution(metrics_text: str) -> dict:
    """Parse one /metrics exposition payload into the engine-internal
    attribution block. Unknown series pass through untouched; a payload
    that fails the grammar raises (a gate must not silently lose its
    engine half)."""
    out: dict = {"qos": {}}
    for name, labels, value in parse_exposition(metrics_text):
        if name == "kftpu_serving_requests_total":
            out["requests_completed"] = out.get("requests_completed", 0) \
                + int(value)
        elif name == "kftpu_serving_requests_shed_total":
            out["requests_shed"] = out.get("requests_shed", 0) + int(value)
        elif name == "kftpu_serving_preemptions_total":
            out["preemptions"] = out.get("preemptions", 0) + int(value)
        elif name == "kftpu_serving_queue_delay_p95_ms":
            out["queue_delay_p95_ms"] = round(value, 2)
        elif name == "kftpu_serving_ttft_p95_ms":
            out["engine_ttft_p95_ms"] = round(value, 2)
        elif name == "kftpu_serving_host_gap_p50_ms":
            out["host_gap_p50_ms"] = round(value, 3)
        elif name == "kftpu_serving_host_gap_p99_ms":
            out["host_gap_p99_ms"] = round(value, 3)
        elif name == "kftpu_engine_dispatch_depth":
            out["dispatch_depth"] = int(value)
        elif name == "kftpu_engine_adapters_resident":
            ad = out.setdefault("adapters", {})
            ad["resident"] = ad.get("resident", 0) + int(value)
        elif name == "kftpu_engine_adapter_loads_total":
            ad = out.setdefault("adapters", {})
            ad["loads"] = ad.get("loads", 0) + int(value)
        elif name == "kftpu_engine_adapter_evictions_total":
            ad = out.setdefault("adapters", {})
            ad["evictions"] = ad.get("evictions", 0) + int(value)
        elif name == "kftpu_engine_kv_tier_pressure":
            # A ratio, not a count: int() would flatten 0.8 to 0. Max
            # across engines — the most pressured replica is the story.
            tier = out.setdefault("kv_tier", {})
            tier["tier_pressure"] = max(tier.get("tier_pressure", 0.0),
                                        round(value, 3))
        elif name.startswith("kftpu_engine_kv_"):
            key = name[len("kftpu_engine_kv_"):]
            if key.endswith("_total"):
                key = key[:-len("_total")]
            tier = out.setdefault("kv_tier", {})
            tier[key] = tier.get(key, 0) + int(value)
        elif name.startswith("kftpu_engine_handoffs_"):
            # Cross-host handoff lifecycle (exported/adopted/failed/
            # retried/fallback): a fleet fault names its handoff phase.
            key = name[len("kftpu_engine_handoffs_"):]
            if key.endswith("_total"):
                key = key[:-len("_total")]
            h = out.setdefault("handoff", {})
            h[key] = h.get(key, 0) + int(value)
        elif name.startswith("kftpu_fleet_") \
                or name.startswith("kftpu_obs_"):
            # Fleet observability plane (obs/fleet.py): stitcher +
            # history + burn-rate health. Counters sum across sources;
            # gauges keep the worst (max) sample — the most skewed
            # clock / hottest burn rate is the story.
            fl = out.setdefault("fleet_obs", {})
            key = name[len("kftpu_fleet_"):] \
                if name.startswith("kftpu_fleet_") \
                else name[len("kftpu_obs_"):]
            if key == "slo_alert":
                al = fl.setdefault("slo_alerts", {})
                cls = labels.get("class", "")
                al[cls] = max(al.get(cls, 0), int(value))
            elif key.endswith("_total"):
                key = key[:-len("_total")]
                fl[key] = fl.get(key, 0) + int(value)
            else:
                fl[key] = max(fl.get(key, 0.0), round(value, 3))
        elif name.startswith("kftpu_serving_qos_"):
            cls = labels.get("qos")
            if cls is None:
                continue
            c = out["qos"].setdefault(cls, {})
            if name == "kftpu_serving_qos_requests_total":
                c["completed"] = c.get("completed", 0) + int(value)
            elif name == "kftpu_serving_qos_requests_shed_total":
                c["shed"] = c.get("shed", 0) + int(value)
            elif name == "kftpu_serving_qos_preemptions_total":
                c["preempted"] = c.get("preempted", 0) + int(value)
            elif name == "kftpu_serving_qos_ttft_p95_ms":
                c["ttft_p95_ms"] = round(value, 2)
            elif name == "kftpu_serving_qos_queue_delay_p95_ms":
                c["queue_delay_p95_ms"] = round(value, 2)
    if not out["qos"]:
        del out["qos"]
    return out


def phase_breakdown(trace_ids, tracer: Optional[Tracer] = None) -> dict:
    """Aggregate per-request engine phase durations (queued / prefill /
    decode, ms) to p50/p95 across the given traces. ``trace_coverage``
    counts how many requested traces the ring still held — loadgen runs
    bigger than the ring report partial coverage instead of pretending
    the sample is the population."""
    tracer = tracer or get_tracer()
    per_phase: dict[str, list[float]] = {k: [] for k in PHASE_KEYS}
    covered = 0
    for tid in trace_ids:
        if not tid:
            continue
        tr = tracer.trace(tid)
        if tr is None:
            continue
        ph = phase_durations(tr["spans"])
        if not ph:
            continue
        covered += 1
        for key in PHASE_KEYS:
            if key in ph:
                per_phase[key].append(ph[key])
    out: dict = {"trace_coverage": covered,
                 "requests_traced": sum(1 for t in trace_ids if t)}
    for key, xs in per_phase.items():
        if xs:
            out[key] = {"p50": round(stats.quantile(xs, 0.5), 3),
                        "p95": round(stats.quantile(xs, 0.95), 3)}
    return out


def build_report(run: ScenarioRun, *, metrics_text: Optional[str] = None,
                 tracer: Optional[Tracer] = None) -> dict:
    """One scenario's full attribution report (see module docstring)."""
    sc = run.scenario
    outs = run.outcomes
    ok = [o for o in outs if o.ok]
    ttfts = [o.ttft_s for o in ok if o.ttft_s is not None]
    tpots = [t for t in (o.tpot_s() for o in ok) if t is not None]
    wall = max(run.wall_s, 1e-9)
    by_status: dict[str, int] = {}
    for o in outs:
        by_status[o.status] = by_status.get(o.status, 0) + 1
    report: dict = {
        "scenario": sc.name,
        "arrival": {"process": sc.arrival.process,
                    "rate_rps": sc.arrival.rate_rps},
        "requests": len(outs),
        "by_status": by_status,
        "offered_req_s": round(len(outs) / wall, 3),
        "req_s": round(len(ok) / wall, 3),
        "tokens_per_sec": round(sum(o.tokens for o in ok) / wall, 1),
        "ttft_ms": stats.quantiles_ms(ttfts),
        "tpot_ms": stats.quantiles_ms(tpots),
        "schedule_lag_ms": stats.quantiles_ms(
            [o.lag_s for o in outs], qs=(0.5, 0.95)),
        "prefix_overlap_declared": sc.prefix_overlap,
    }
    if sc.slo_ttft_ms is not None or sc.slo_tpot_ms is not None:
        # The denominator is the SLO-bearing traffic: all requests by
        # default, or only ``slo_classes`` when the scenario scopes its
        # SLO (a batch tier without a latency SLO is judged on
        # completion, not TTFT — the platform's QoS semantics).
        slo_outs = [o for o in outs
                    if not sc.slo_classes or o.qos in sc.slo_classes]

        def _good(o) -> bool:
            if o.status != "ok":
                return False
            if sc.slo_ttft_ms is not None and (
                    o.ttft_s is None or o.ttft_s * 1e3 > sc.slo_ttft_ms):
                return False
            if sc.slo_tpot_ms is not None:
                tpot = o.tpot_s()
                if tpot is not None and tpot * 1e3 > sc.slo_tpot_ms:
                    return False
            return True

        good = sum(1 for o in slo_outs if _good(o))
        report["goodput"] = {
            "slo_ttft_ms": sc.slo_ttft_ms,
            # Goodput is measured against OFFERED load: a shed or timed-
            # out request is an SLO miss, not a denominator dropout.
            "ratio": round(good / max(len(slo_outs), 1), 4),
            "good_requests": good,
        }
        if sc.slo_tpot_ms is not None:
            report["goodput"]["slo_tpot_ms"] = sc.slo_tpot_ms
        if sc.slo_classes:
            report["goodput"]["slo_classes"] = list(sc.slo_classes)
    adapters = sorted({o.adapter for o in outs if o.adapter})
    if adapters:
        # Per-adapter TTFT/TPOT attribution: the split that shows ONE
        # tenant degrading (its adapter thrashing the hot set) while
        # the aggregate still looks healthy.
        ad_out: dict = {}
        for aid in adapters:
            a_ok = [o for o in ok if o.adapter == aid]
            a_all = [o for o in outs if o.adapter == aid]
            ad_out[aid] = {
                "requests": len(a_all), "completed": len(a_ok),
                "ttft_ms": stats.quantiles_ms(
                    [o.ttft_s for o in a_ok if o.ttft_s is not None],
                    qs=(0.5, 0.95)),
                "tpot_ms": stats.quantiles_ms(
                    [t for t in (o.tpot_s() for o in a_ok)
                     if t is not None], qs=(0.5, 0.95)),
            }
        report["adapters"] = ad_out
    qos_out: dict = {}
    for cls in sorted({o.qos for o in outs}):
        cls_ok = [o for o in ok if o.qos == cls]
        cls_all = [o for o in outs if o.qos == cls]
        entry = {"requests": len(cls_all), "completed": len(cls_ok),
                 "shed": sum(1 for o in cls_all if o.status == "shed"),
                 "ttft_ms": stats.quantiles_ms(
                     [o.ttft_s for o in cls_ok if o.ttft_s is not None],
                     qs=(0.5, 0.95))}
        qos_out[cls] = entry
    if len(qos_out) > 1:
        report["qos"] = qos_out
    if metrics_text is not None:
        report["engine"] = engine_attribution(metrics_text)
    report["phases"] = phase_breakdown(
        [o.trace_id for o in outs], tracer=tracer)
    return report


def report_registry(reports) -> MetricsRegistry:
    """Render client-side scenario results as ``kftpu_loadgen_*`` series
    through the platform's single exposition path (one labeled sample
    set per scenario), the same series names as the JAX package's."""
    reg = MetricsRegistry()
    requests = reg.counter("kftpu_loadgen_requests_total")
    failed = reg.counter("kftpu_loadgen_requests_failed_total")
    req_s = reg.gauge("kftpu_loadgen_req_per_sec")
    offered = reg.gauge("kftpu_loadgen_offered_req_per_sec")
    ttft_p50 = reg.gauge("kftpu_loadgen_ttft_p50_ms")
    ttft_p95 = reg.gauge("kftpu_loadgen_ttft_p95_ms")
    tpot_p50 = reg.gauge("kftpu_loadgen_tpot_p50_ms")
    goodput = reg.gauge("kftpu_loadgen_goodput_ratio")
    lag_p95 = reg.gauge("kftpu_loadgen_schedule_lag_p95_ms")
    for rep in reports:
        s = rep["scenario"]
        total = rep.get("requests", 0)
        bad = sum(n for st, n in rep.get("by_status", {}).items()
                  if st != "ok")
        requests.inc(total, scenario=s)
        failed.inc(bad, scenario=s)
        req_s.set(rep.get("req_s", 0.0), scenario=s)
        offered.set(rep.get("offered_req_s", 0.0), scenario=s)
        if rep.get("ttft_ms"):
            ttft_p50.set(rep["ttft_ms"].get("p50", 0.0), scenario=s)
            ttft_p95.set(rep["ttft_ms"].get("p95", 0.0), scenario=s)
        if rep.get("tpot_ms"):
            tpot_p50.set(rep["tpot_ms"].get("p50", 0.0), scenario=s)
        if "goodput" in rep:
            goodput.set(rep["goodput"]["ratio"], scenario=s)
        if rep.get("schedule_lag_ms"):
            lag_p95.set(rep["schedule_lag_ms"].get("p95", 0.0), scenario=s)
    return reg
