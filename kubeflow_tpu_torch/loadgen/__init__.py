"""Trace-driven open-loop serving loadgen (a copy of
``kubeflow_tpu/loadgen``, driving the port's engine and model server).

``scenario`` declares traffic (arrival process, length distributions,
shared-prefix overlap, QoS mix) with a seeded deterministic schedule;
``runner`` replays it open-loop against a live engine or model server;
``report`` joins client-observed percentiles with engine-internal
/metrics signals and per-phase span breakdowns; ``gate`` turns two
report matrices into a thresholded regression verdict.
"""

from kubeflow_tpu_torch.loadgen.gate import (          # noqa: F401
    compare_matrix, compare_scenario, noise_band_pct, spread_pct,
)
from kubeflow_tpu_torch.loadgen.report import (        # noqa: F401
    ATTRIBUTION_SERIES, build_report, engine_attribution,
    phase_breakdown, report_registry,
)
from kubeflow_tpu_torch.loadgen.runner import (        # noqa: F401
    EngineTarget, RequestOutcome, ScenarioRun, ServerTarget, run_scenario,
    tokens_to_text,
)
from kubeflow_tpu_torch.loadgen.scenario import (      # noqa: F401
    Arrival, LengthDist, Scenario, ScheduledRequest, arrival_times,
    build_schedule, measured_prefix_overlap, standard_matrix,
)
