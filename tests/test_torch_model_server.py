"""The port's predictor replica as a process: ``python -m
kubeflow_tpu_torch.runtime.worker_main`` with ``KFTPU_ENTRYPOINT=
model_server`` on the CPU (``KFTPU_PLATFORM=cpu``, tiny fp32 preset).

The worker loads the JAX package's weights through the port's ``file://``
(a port checkpoint of ``params_from_jax`` of a JAX tree), serves
completions, chat (streamed and not), predict, infer and ``:explain``, and
its transformer hop's output must equal the JAX ``ModelServer``'s for the
same handler and weights. SIGTERM ends it with 143, an unknown entrypoint
with 2, a multi-process world and a card-less ``KFTPU_PLATFORM=gpu`` (or
an unset one) with a nonzero code before anything serves."""

import json
import os
import signal
import subprocess
import sys
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from kubeflow_tpu.core.serving import BatchingSpec as JBatchingSpec  # noqa: E402
from kubeflow_tpu.models import config as jconfig  # noqa: E402
from kubeflow_tpu.models import decoder as jdecoder  # noqa: E402
from kubeflow_tpu.serve import engine as jengine  # noqa: E402
from kubeflow_tpu.serve import server as jserver  # noqa: E402
from kubeflow_tpu_torch.models.convert import params_from_jax  # noqa: E402
from kubeflow_tpu_torch.runtime.bootstrap import (  # noqa: E402
    WorkerEnv, free_port,
)
from kubeflow_tpu_torch.serve.model_server import strip  # noqa: E402
from kubeflow_tpu_torch.train.checkpoint import CheckpointManager  # noqa: E402
from port_threads import torch_on_one_thread  # noqa: E402,F401

REPO = Path(__file__).resolve().parent.parent
MODEL = {"preset": "tiny", "overrides": {"vocab_size": 512,
                                         "dtype": "float32"}}
BATCHING = {"max_batch_size": 2, "max_seq_len": 64,
            "prefill_buckets": [16, 64]}
PROMPTS = ("  hello there  ", "\tabc def\n")


def _env(entrypoint: str, config: dict, **kw) -> dict:
    wenv = WorkerEnv(coordinator_address="127.0.0.1:0", num_processes=1,
                     process_id=0, job="default/predictor", replica_index=0,
                     entrypoint=entrypoint, config=config, parallelism={},
                     platform="cpu")
    for k, v in kw.items():
        setattr(wenv, k, v)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("KFTPU_")}
    env.update(wenv.to_env())
    env["PYTHONPATH"] = str(REPO)
    return env


def _spawn(env: dict) -> subprocess.Popen:
    return subprocess.Popen(
        [sys.executable, "-m", "kubeflow_tpu_torch.runtime.worker_main"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)


def _call(url: str, path: str, body=None, timeout: float = 60.0):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url + path, data=data,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _wait_ready(proc: subprocess.Popen, url: str, timeout: float = 90.0):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        if proc.poll() is not None:
            raise AssertionError(f"worker exited {proc.returncode}: "
                                 f"{proc.stderr.read()[-2000:]}")
        try:
            if _call(url, "/v2/health/ready", timeout=2.0)[0] == 200:
                return
        except OSError:
            pass
        time.sleep(0.2)
    raise AssertionError("worker never became ready")


@pytest.fixture(scope="module")
def jax_params():
    cfg = jconfig.preset("tiny", vocab_size=512, dtype="float32")
    return cfg, jdecoder.init_decoder_params(jax.random.PRNGKey(0), cfg)


@pytest.fixture(scope="module")
def worker(tmp_path_factory, jax_params):
    """A model_server worker on the JAX weights, through ``file://``."""
    _, jparams = jax_params
    ckpt = tmp_path_factory.mktemp("ckpt")
    tree = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    mgr = CheckpointManager(str(ckpt))
    mgr.save(3, {"params": tree, "step": 3})
    mgr.close()       # the save is asynchronous
    port = free_port()
    proc = _spawn(_env("model_server", {
        "model": MODEL, "storage_uri": f"file://{ckpt}",
        "batching": BATCHING, "port": port, "service": "tiny",
        "explainer": {"handler": "grad_x_input"},
        "transformer": {"handler": "strip"}}))
    url = f"http://127.0.0.1:{port}"
    try:
        _wait_ready(proc, url)
        yield proc, url
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)


@pytest.fixture(scope="module")
def jax_server(jax_params):
    cfg, jparams = jax_params
    engine = jengine.LLMEngine(cfg, JBatchingSpec(**BATCHING), params=jparams)
    srv = jserver.ModelServer("tiny", engine, transformer=strip)
    srv.start()
    yield srv.url
    srv.stop()


def test_routes_answer(worker):
    _, url = worker
    for prompt in PROMPTS:
        status, raw = _call(url, "/v1/completions",
                            {"prompt": prompt, "max_tokens": 5})
        assert status == 200, raw
        out = json.loads(raw)
        assert out["object"] == "text_completion"
        assert out["usage"]["completion_tokens"] >= 1
    status, raw = _call(url, "/v1/chat/completions",
                        {"messages": [{"role": "user", "content": "hi"}],
                         "max_tokens": 4})
    assert status == 200 and json.loads(raw)["object"] == "chat.completion"
    status, raw = _call(url, "/v1/chat/completions",
                        {"messages": [{"role": "user", "content": "hi"}],
                         "max_tokens": 4, "stream": True})
    chunks = [ln[6:] for ln in raw.split("\n") if ln.startswith("data: ")]
    assert status == 200 and chunks[-1] == "[DONE]"
    assert all("delta" in json.loads(c)["choices"][0] for c in chunks[:-1])
    status, raw = _call(url, "/v1/models/tiny:predict",
                        {"instances": ["abc"], "max_tokens": 3})
    assert status == 200 and len(json.loads(raw)["predictions"]) == 1
    status, raw = _call(url, "/v2/models/tiny/infer",
                        {"inputs": [{"name": "text", "datatype": "BYTES",
                                     "shape": [1], "data": ["abc"]}],
                         "max_tokens": 3})
    assert status == 200
    status, raw = _call(url, "/v1/models/tiny:explain",
                        {"instances": ["  hey  "]})
    assert status == 200
    (exp,) = json.loads(raw)["explanations"]
    # The pre hop stripped the prompt: BOS + 3 bytes.
    assert exp["method"] == "grad_x_input"
    assert len(exp["scores"]) == len(exp["tokens"]) == 4
    assert all(np.isfinite(exp["scores"]))
    status, raw = _call(url, "/v1/models/tiny:explain",
                        {"instances": ["x" * 100]})
    assert status == 400 and "limit" in json.loads(raw)["error"]


def test_transformer_hops_match_the_jax_server(worker, jax_server):
    """The same handler (``strip``, pre and post) over the same weights:
    the port worker's answers equal the JAX server's, byte for byte."""
    _, url = worker
    for prompt in PROMPTS:
        body = {"prompt": prompt, "max_tokens": 6}
        got = json.loads(_call(url, "/v1/completions", body)[1])
        want = json.loads(_call(jax_server, "/v1/completions", body)[1])
        assert got["choices"][0]["text"] == want["choices"][0]["text"]
        assert got["usage"] == want["usage"]
        body = {"instances": [prompt], "max_tokens": 6}
        got = json.loads(_call(url, "/v1/models/tiny:predict", body)[1])
        want = json.loads(_call(jax_server, "/v1/models/tiny:predict",
                                body)[1])
        assert got["predictions"] == want["predictions"]
    body = {"messages": [{"role": "user", "content": " hi "}],
            "max_tokens": 6}
    got = json.loads(_call(url, "/v1/chat/completions", body)[1])
    want = json.loads(_call(jax_server, "/v1/chat/completions", body)[1])
    assert got["choices"] == want["choices"]


def test_sigterm_exits_143_and_closes_the_port(worker):
    proc, url = worker
    proc.send_signal(signal.SIGTERM)
    assert proc.wait(timeout=30) == 143
    with pytest.raises(OSError):
        _call(url, "/v2/health/ready", timeout=2.0)


def _run(env: dict, timeout: float = 60.0) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, "-m", "kubeflow_tpu_torch.runtime.worker_main"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=timeout)


def test_unknown_entrypoint_and_config_errors_exit_2():
    assert _run(_env("no_such_entrypoint", {})).returncode == 2
    env = _env("noop", {})
    del env["KFTPU_ENTRYPOINT"]
    assert _run(env).returncode == 2
    assert _run({**_env("noop", {}),
                 "KFTPU_NUM_PROCESSES": "two"}).returncode == 2


def test_builtin_entrypoints_exit_codes(tmp_path):
    assert _run(_env("noop", {})).returncode == 0
    assert _run(_env("fail", {"exit_code": 7})).returncode == 7
    # The heartbeat file is touched while the entrypoint runs.
    beat = tmp_path / "hb" / "beat"
    assert _run(_env("sleep", {"seconds": 0.2},
                     heartbeat_file=str(beat))).returncode == 0
    assert float(beat.read_text()) > 0


def test_objective_probe_and_flaky_in_process(tmp_path):
    """The control-plane built-ins, called in process: the probe's metrics
    series ends at its bowl's value; ``flaky`` fails retryably until its
    attempt count reaches the threshold."""
    from kubeflow_tpu_torch.runtime.entrypoints import (
        WorkerContext, resolve_entrypoint,
    )

    def ctx(config, **kw):
        env = WorkerEnv(coordinator_address="127.0.0.1:0", num_processes=1,
                        process_id=0, job="default/t", replica_index=0,
                        entrypoint="x", config=config, parallelism={},
                        workdir=str(tmp_path), **kw)
        return WorkerContext(env=env)

    probe = resolve_entrypoint("objective_probe")
    assert probe(ctx({"x": 0.3, "y": -0.2, "steps": 3})) == 0
    rows = [json.loads(ln) for ln in
            (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in rows] == [0, 1, 2]
    assert rows[-1]["objective"] == pytest.approx(0.0)
    flaky = resolve_entrypoint("flaky")
    conf = {"attempt_file": str(tmp_path / "attempts"), "fail_times": 2}
    assert [flaky(ctx(conf)) for _ in range(3)] == [130, 130, 0]


def test_multi_process_world_is_refused():
    """A gang serves only as one tensor-parallel engine, parallelism
    {model: N} (tests/test_torch_tp_engine.py); another world raises with
    the ROADMAP pointer before it joins."""
    port = free_port()
    out = _run(_env("model_server", {"model": MODEL, "port": port},
                    num_processes=2, parallelism={"data": 2}))
    assert out.returncode != 0
    assert "Queue 1 item 9e" in out.stderr


@pytest.mark.parametrize("platform", ["gpu", None], ids=["gpu", "unset"])
def test_gpu_platform_without_a_card_never_serves(platform):
    """A platform other than ``cpu``, or none set, means the card: without
    one the worker exits nonzero, names ``KFTPU_PLATFORM=cpu`` and never
    serves."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    port = free_port()
    env = _env("model_server", {"model": MODEL, "port": port,
                                "batching": BATCHING}, platform=platform)
    assert ("KFTPU_PLATFORM" in env) == (platform is not None)
    out = _run(env)
    assert out.returncode != 0
    assert "KFTPU_PLATFORM=cpu" in out.stderr
    with pytest.raises(OSError):
        _call(f"http://127.0.0.1:{port}", "/v2/health/ready", timeout=2.0)


def test_unknown_batching_field_is_refused():
    out = _run(_env("model_server", {"model": MODEL, "port": free_port(),
                                     "batching": {"max_batch_sise": 2}}))
    assert out.returncode != 0 and "max_batch_sise" in out.stderr
