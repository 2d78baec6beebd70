"""The port's loadgen (``kubeflow_tpu_torch/loadgen``) against the JAX
package's: the same seeded schedules, the same token outputs and statuses
when ``EngineTarget`` replays a scenario on a tiny port engine and on a
tiny JAX engine over the same weights, the same attribution parsed from
the port server's ``/metrics``, the same gate verdicts, and a
``ServerTarget`` replay against the port's ``ModelServer``."""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from kubeflow_tpu import loadgen as jlg  # noqa: E402
from kubeflow_tpu.core.serving import BatchingSpec as JBatchingSpec  # noqa: E402
from kubeflow_tpu.models import config as jconfig  # noqa: E402
from kubeflow_tpu.models import decoder as jdecoder  # noqa: E402
from kubeflow_tpu.serve import engine as jengine  # noqa: E402
from kubeflow_tpu_torch import loadgen as tlg  # noqa: E402
from kubeflow_tpu_torch.core.serving import BatchingSpec  # noqa: E402
from kubeflow_tpu_torch.models.config import preset  # noqa: E402
from kubeflow_tpu_torch.models.convert import params_from_jax  # noqa: E402
from kubeflow_tpu_torch.obs.trace import Tracer  # noqa: E402
from kubeflow_tpu_torch.serve.engine import LLMEngine  # noqa: E402
from kubeflow_tpu_torch.serve.server import (  # noqa: E402
    ModelServer, serving_metrics_registry,
)
from port_threads import torch_on_one_thread  # noqa: E402,F401

SPEC = dict(max_batch_size=4, max_seq_len=256, prefill_buckets=[32, 64, 256])
MATRIX = dict(num_requests=6, rate_rps=40.0, prompt_len=12, max_new=4,
              multi_turn_think_s=0.02)


def _schedule_rows(schedule):
    return [dataclasses.asdict(sr) for sr in schedule]


@pytest.mark.parametrize("seed", [0, 7])
def test_schedules_equal_the_jax_builder(seed):
    port = tlg.standard_matrix(seed=seed, **MATRIX)
    ref = jlg.standard_matrix(seed=seed, **MATRIX)
    assert [s.name for s in port] == [s.name for s in ref]
    checked = 0
    for ps, js in zip(port, ref):
        if ps.name == "multi_adapter":
            continue            # LoRA model ids: the port serves no adapters
        assert dataclasses.asdict(ps) == dataclasses.asdict(js)
        got = tlg.build_schedule(ps, vocab_size=256, max_prompt_len=200)
        want = jlg.build_schedule(js, vocab_size=256, max_prompt_len=200)
        assert _schedule_rows(got) == _schedule_rows(want), ps.name
        checked += 1
    assert checked == 5


@pytest.fixture(scope="module")
def engines():
    jcfg = jconfig.preset("tiny", dtype="float32", max_seq_len=256)
    jparams = jdecoder.init_decoder_params(jax.random.PRNGKey(0), jcfg)
    jeng = jengine.LLMEngine(jcfg, JBatchingSpec(**SPEC), params=jparams)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    eng = LLMEngine(preset("tiny", dtype="float32", max_seq_len=256),
                    BatchingSpec(**SPEC), params=params, device="cpu")
    jeng.start()
    eng.start()
    yield jeng, eng
    jeng.stop()
    eng.stop()


def _scenario(lg, name):
    return next(s for s in lg.standard_matrix(seed=0, **MATRIX)
                if s.name == name)


@pytest.mark.parametrize("name", ["uniform", "multi_turn"])
def test_engine_target_matches_the_jax_engine(engines, name):
    jeng, eng = engines
    want = jlg.run_scenario(jlg.EngineTarget(jeng), _scenario(jlg, name),
                            vocab_size=256, max_prompt_len=100)
    got = tlg.run_scenario(tlg.EngineTarget(eng), _scenario(tlg, name),
                           vocab_size=256, max_prompt_len=100,
                           tracer=Tracer())
    assert [o.status for o in got.outcomes] == \
        [o.status for o in want.outcomes]
    assert all(o.status == "ok" for o in got.outcomes)
    assert [tuple(o.gen) for o in got.outcomes] == \
        [tuple(o.gen) for o in want.outcomes]
    assert [o.prompt_len for o in got.outcomes] == \
        [o.prompt_len for o in want.outcomes]


def test_engine_target_refuses_adapters(engines):
    _, eng = engines
    sr = tlg.build_schedule(_scenario(tlg, "uniform"), vocab_size=256,
                            max_prompt_len=100)[0]
    out = tlg.EngineTarget(eng).issue(
        dataclasses.replace(sr, adapter="adpt-0"), None, 10.0)
    assert out.status == "error"
    with pytest.raises(KeyError, match="adpt-0"):
        eng.submit([5, 6], adapter="adpt-0")


def test_report_reads_the_port_metrics_like_the_jax_report(engines):
    _, eng = engines
    # The process tracer: the engine opens its phase spans there.
    run = tlg.run_scenario(tlg.EngineTarget(eng), _scenario(tlg, "uniform"),
                           vocab_size=256, max_prompt_len=100)
    text = serving_metrics_registry([("tiny", eng)]).render()
    rep = tlg.build_report(run, metrics_text=text)
    assert rep["engine"] == jlg.engine_attribution(text)
    assert rep["engine"]["requests_completed"] >= len(run.outcomes)
    assert rep["by_status"] == {"ok": len(run.outcomes)}
    assert set(rep["ttft_ms"]) == {"p50", "p95", "p99"}
    # The engine's phase spans joined the loadgen's per-request traces.
    assert rep["phases"]["trace_coverage"] == len(run.outcomes)
    assert {"queued_ms", "prefill_ms", "decode_ms"} <= set(rep["phases"])
    assert tlg.report_registry([rep]).render() == \
        jlg.report_registry([rep]).render()


def test_server_target_replays_over_http():
    cfg = preset("tiny", vocab_size=512, dtype="float32", max_seq_len=256)
    eng = LLMEngine(cfg, BatchingSpec(**SPEC), device="cpu")
    server = ModelServer("tiny", eng)
    server.start()
    try:
        sc = _scenario(tlg, "shared_prefix")
        run = tlg.run_scenario(tlg.ServerTarget(server.url, model="tiny"),
                               sc, vocab_size=256, max_prompt_len=100)
        assert all(o.status == "ok" and o.tokens >= 1 and o.ttft_s
                   for o in run.outcomes)
        rep = tlg.build_report(run, metrics_text=server.metrics_text())
        assert rep["engine"]["requests_completed"] == len(run.outcomes)
    finally:
        server.stop()


def _row(name, req_s, ttft_p95, **extra):
    row = {"scenario": name, "req_s": req_s,
           "ttft_ms": {"p50": ttft_p95 / 2, "p95": ttft_p95}}
    row.update(extra)
    return row


@pytest.mark.parametrize("base,cand,kw", [
    (_row("u", 10.0, 50.0), _row("u", 7.0, 50.0), {"band_pct": 20.0}),
    (_row("u", 10.0, 50.0), _row("u", 10.0, 90.0), {"band_pct": 20.0}),
    (_row("u", 10.0, 0.5), _row("u", 10.0, 2.0),
     {"band_pct": 20.0, "ttft_floor_ms": 5.0}),
    (_row("u", 10.0, 50.0), _row("u", 9.0, 55.0), {"band_pct": 20.0}),
])
def test_gate_compare_scenario_equals_the_jax_gate(base, cand, kw):
    assert tlg.compare_scenario(base, cand, **kw) == \
        jlg.compare_scenario(base, cand, **kw)


def test_gate_compare_matrix_equals_the_jax_gate():
    base = _row("u", 10.0, 50.0, engine={"queue_delay_p95_ms": 3.0},
                phases={"queued_ms": {"p50": 1}})
    cand = _row("u", 4.0, 500.0, engine={"queue_delay_p95_ms": 400.0},
                phases={"queued_ms": {"p50": 300}})
    for args in (([base], [cand]), ([_row("a", 1, 1), _row("b", 1, 1)],
                                     [_row("a", 1, 1)])):
        got = tlg.compare_matrix(*args, band_pct=15.0)
        assert got == jlg.compare_matrix(*args, band_pct=15.0)
    assert not got["ok"]
    for spreads in ([1.0], [20.0], [90.0]):
        assert tlg.noise_band_pct(spreads) == jlg.noise_band_pct(spreads)
    with pytest.raises(ValueError, match="noise band"):
        tlg.compare_matrix([_row("a", 1, 1)], [_row("a", 1, 1)])
