"""Thresholded serving-perf comparison — the gate's decision logic.

The serving analogue of the train bench's two-segment methodology
(``bench.py``): every measured scenario runs as two back-to-back
segments in one process, the run-to-run spread between them IS the
observable noise, and the regression threshold derives from it — a
quiet host gets a tight gate, a noisy CI box widens its own band
instead of flaking. ``compare_matrix`` then judges a candidate matrix
against a baseline matrix per scenario on the two headline metrics
(req/s down, TTFT p95 up) and attaches the ATTRIBUTION DIFF for every
regression: the engine-internal signals and phase breakdowns
side-by-side, so the failure message says where the latency went.
"""

from __future__ import annotations

from typing import Optional


def noise_band_pct(spread_pcts, *, mult: float = 2.0,
                   floor_pct: float = 10.0, cap_pct: float = 60.0) -> float:
    """Regression threshold (percent) from observed two-segment spreads:
    ``max(floor, mult × max(spread))``, capped so a pathological warmup
    spread cannot disable the gate outright."""
    worst = max([float(s) for s in spread_pcts] or [0.0])
    return min(max(floor_pct, mult * worst), cap_pct)


def spread_pct(a: float, b: float) -> float:
    """Two-segment relative spread, percent of the larger value."""
    hi = max(abs(a), abs(b))
    if hi <= 0:
        return 0.0
    return 100.0 * abs(a - b) / hi


def _attribution_diff(baseline: dict, candidate: dict) -> dict:
    """Side-by-side engine/phase attribution for a regression message."""
    diff: dict = {}
    for key in ("engine", "phases", "qos"):
        b, c = baseline.get(key), candidate.get(key)
        if b is not None or c is not None:
            diff[key] = {"baseline": b, "candidate": c}
    return diff


def compare_scenario(baseline: dict, candidate: dict, *,
                     band_pct: float,
                     ttft_floor_ms: float = 5.0) -> list[str]:
    """Regression verdicts for one scenario (empty list = clean).

    - req/s: candidate more than ``band_pct`` below baseline;
    - TTFT p95: candidate more than ``band_pct`` above baseline AND more
      than ``ttft_floor_ms`` absolute (sub-millisecond CPU TTFTs jitter
      by whole multiples without meaning anything).
    """
    problems: list[str] = []
    b_rps, c_rps = baseline.get("req_s", 0.0), candidate.get("req_s", 0.0)
    if b_rps > 0 and c_rps < b_rps * (1.0 - band_pct / 100.0):
        problems.append(
            f"req/s regressed: {c_rps:.3f} < {b_rps:.3f} "
            f"- {band_pct:.0f}% band")
    b_ttft = (baseline.get("ttft_ms") or {}).get("p95")
    c_ttft = (candidate.get("ttft_ms") or {}).get("p95")
    if b_ttft is not None and c_ttft is not None \
            and c_ttft > b_ttft * (1.0 + band_pct / 100.0) \
            and c_ttft - b_ttft > ttft_floor_ms:
        problems.append(
            f"ttft p95 regressed: {c_ttft:.1f}ms > {b_ttft:.1f}ms "
            f"+ {band_pct:.0f}% band")
    return problems


def compare_matrix(baseline_rows, candidate_rows, *,
                   band_pct: Optional[float] = None,
                   bands: Optional[dict] = None,
                   ttft_floor_ms: float = 5.0) -> dict:
    """Judge a candidate scenario matrix against a baseline matrix.

    ``bands`` maps scenario name → band percent (per-scenario noise);
    ``band_pct`` is the shared fallback. Scenarios present on only one
    side are reported as coverage drift (a silently dropped scenario
    must not read as a pass). Returns ``{"ok", "regressions": [{
    scenario, problems, diff}], "coverage": [...]}``."""
    base = {r["scenario"]: r for r in baseline_rows}
    cand = {r["scenario"]: r for r in candidate_rows}
    regressions = []
    coverage = [f"scenario {name!r} present only in "
                f"{'baseline' if name in base else 'candidate'}"
                for name in sorted(set(base) ^ set(cand))]
    for name in sorted(set(base) & set(cand)):
        band = (bands or {}).get(name, band_pct)
        if band is None:
            raise ValueError(f"no noise band for scenario {name!r}")
        problems = compare_scenario(base[name], cand[name],
                                    band_pct=band,
                                    ttft_floor_ms=ttft_floor_ms)
        if problems:
            regressions.append({
                "scenario": name, "band_pct": band, "problems": problems,
                "diff": _attribution_diff(base[name], cand[name]),
            })
    return {"ok": not regressions and not coverage,
            "regressions": regressions, "coverage": coverage}
