"""The port's training entry points through ``runtime.worker_main`` on the
CPU (``KFTPU_PLATFORM=cpu``):

- ``llm_pretrain`` on ``tiny-moe``: exit 0, one ``metrics.jsonl`` line per
  step with ``loss`` and ``aux_loss``, a checkpoint whose params load
  through ``load_params("file://…")`` (those of an in-process ``Trainer``
  run from the same config, within 1e-5) and serve;
- ``vision_train`` (ViT on ``tiny-vit``, CLIP on ``tiny-clip``) and
  ``torch_train``: exit 0, every ``metrics.jsonl`` value finite;
- the registry holds all three beside ``model_server``; without a card
  and without ``cpu`` each entry point raises;
- each runs as a two-process gloo gang through ``worker_main``
  (``tests/dist_support.py``; the four-process gangs run inside
  ``test_torch_distributed_train.py``'s): exit 0, metrics from the
  coordinator alone, a vision gang's first loss that of the one-process
  step on the same global batch, a ``torch_train`` gang's ranks ending on
  equal weights; a gang whose second rank never starts exits retryable
  within its rendezvous timeout, and ``_classify_exit`` maps each torch
  error type.
"""

import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from dist_support import check_gang, finish, spawn_gang

from kubeflow_tpu_torch.core.serving import BatchingSpec
from kubeflow_tpu_torch.models.config import preset
from kubeflow_tpu_torch.runtime.bootstrap import WorkerEnv
from kubeflow_tpu_torch.runtime.entrypoints import (
    WorkerContext, resolve_entrypoint,
)
from kubeflow_tpu_torch.serve.engine import LLMEngine, SamplingParams
from kubeflow_tpu_torch.serve.storage import load_params
from kubeflow_tpu_torch.train import tree as T
from kubeflow_tpu_torch.train.trainer import Trainer, TrainerConfig
from port_threads import torch_on_one_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
ENTRYPOINTS = ("llm_pretrain", "vision_train", "torch_train")


def _wenv(entrypoint: str, config: dict, workdir, **kw) -> WorkerEnv:
    return WorkerEnv(coordinator_address="127.0.0.1:0",
                     num_processes=kw.pop("num_processes", 1), process_id=0,
                     job="default/train", replica_index=0,
                     entrypoint=entrypoint, config=config, parallelism={},
                     platform=kw.pop("platform", "cpu"),
                     workdir=str(workdir), **kw)


def _spawn(wenv: WorkerEnv) -> subprocess.Popen:
    env = {k: v for k, v in os.environ.items() if not k.startswith("KFTPU_")}
    env.update(wenv.to_env())
    env["PYTHONPATH"] = str(REPO)
    return subprocess.Popen(
        [sys.executable, "-m", "kubeflow_tpu_torch.runtime.worker_main"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)


def _finish(proc: subprocess.Popen, workdir: Path) -> list[dict]:
    out, err = proc.communicate(timeout=240)
    assert proc.returncode == 0, err[-3000:]
    return [json.loads(x) for x in
            (workdir / "metrics.jsonl").read_text().splitlines()]


def _llm_config(ckpt: str) -> dict:
    return {"model": "tiny-moe",
            "model_overrides": {"dtype": "float32", "n_layers": 1},
            "data": {"seq_len": 32, "global_batch": 2}, "steps": 3,
            "log_every": 1, "checkpoint_dir": ckpt, "checkpoint_every": 3,
            "optimizer": {"learning_rate": 3e-3, "warmup_steps": 1},
            "watchdog_enabled": False}


def test_workers_train_on_the_cpu(tmp_path):
    """All three training workers at once, each in its own process."""
    jobs = {
        "llm": ("llm_pretrain", _llm_config(str(tmp_path / "ckpt"))),
        "vit": ("vision_train", {"family": "vit", "model": "tiny-vit",
                                 "steps": 3, "batch": 4,
                                 "model_overrides": {"dtype": "float32"}}),
        "clip": ("vision_train", {"family": "clip", "model": "tiny-clip",
                                  "steps": 2, "batch": 4}),
        "torch": ("torch_train", {"steps": 5, "batch": 8}),
    }
    procs = {}
    for name, (ep, conf) in jobs.items():
        (tmp_path / name).mkdir()
        procs[name] = _spawn(_wenv(ep, conf, tmp_path / name))
    rows = {name: _finish(p, tmp_path / name) for name, p in procs.items()}

    assert [r["step"] for r in rows["llm"]] == [1, 2, 3]
    for r in rows["llm"]:
        assert math.isfinite(r["loss"]) and r["aux_loss"] > 0
        assert abs(r["loss"] - r["ce_loss"] - 0.01 * r["aux_loss"]) <= 1e-5
    assert [r["step"] for r in rows["vit"]] == [0, 1, 2]
    assert {"loss", "accuracy", "grad_norm"} <= set(rows["vit"][0])
    assert {"loss", "img_to_txt_acc", "temperature",
            "grad_norm"} <= set(rows["clip"][0])
    assert len(rows["torch"]) == 5
    assert (tmp_path / "torch" / "checkpoint.pt").exists()
    for name in ("vit", "clip", "torch"):
        for r in rows[name]:
            assert all(math.isfinite(v) for v in r.values()), (name, r)

    # The worker's step-3 checkpoint: its params load through file://, are
    # those of the same run in process, and serve.
    conf = _llm_config(str(tmp_path / "ckpt-in-process"))
    cfg = preset(conf["model"], **conf["model_overrides"])
    loaded = load_params(f"file://{tmp_path / 'ckpt'}", cfg, device="cpu")
    tr = Trainer(TrainerConfig.from_dict(conf), device="cpu",
                 workdir=str(tmp_path / "in-process"))
    tr.run()
    mine = T.flatten(tr.task.state["params"])
    got = T.flatten(loaded)
    assert list(got) == list(mine)
    for k in got:
        # Two processes' CPU kernels may split a reduction differently.
        torch.testing.assert_close(got[k], mine[k].detach(), rtol=0,
                                   atol=1e-5)
    spec = BatchingSpec(max_batch_size=2, max_seq_len=64,
                        prefill_buckets=[16, 64])
    toks = LLMEngine(cfg, spec, params=loaded, device="cpu").generate(
        [5, 17, 3, 99], SamplingParams(max_new_tokens=6))
    assert len(toks) == 6


def test_registered_beside_the_serving_entrypoint():
    for name in ENTRYPOINTS + ("model_server",):
        assert callable(resolve_entrypoint(name))


def _gang_config(name: str, tmp_path) -> dict:
    """The config of a two-process gang of ``name``."""
    if name == "llm_pretrain":
        return dict(_llm_config(str(tmp_path / "ck")), model="tiny", steps=2,
                    model_overrides={"dtype": "float32", "n_layers": 1})
    if name == "vision_train":
        return {"family": "vit", "model": "tiny-vit", "steps": 2,
                "batch": 4, "model_overrides": {"dtype": "float32"}}
    return {"steps": 4, "batch": 8}


def _gangs(n: int, base) -> dict:
    """All three entry points as ``n``-process gangs at once; each
    gang's (config, workdirs) after every rank exited 0."""
    procs, out = {}, {}
    for name in ENTRYPOINTS:
        conf = _gang_config(name, base / name)
        dirs = [base / name / "job" / f"worker-{r}" for r in range(n)]
        procs[name] = spawn_gang(name, conf, n, dirs)
        out[name] = (conf, dirs)
    for name, ps in procs.items():
        for r, (rc, _, err) in enumerate(finish(ps)):
            assert rc == 0, f"{name} rank {r} exit {rc}:\n{err[-4000:]}"
    return out


@pytest.fixture(scope="module")
def gangs2(tmp_path_factory):
    return _gangs(2, tmp_path_factory.mktemp("gangs2"))


@pytest.mark.parametrize("name", ENTRYPOINTS)
def test_multi_process_world_is_refused(name, gangs2):
    """No longer refused: a two-process world of each entry point runs as
    a gloo gang through ``worker_main`` (``llm_pretrain`` on the
    default all-``fsdp`` mesh, ``vision_train`` ViT with two rows a rank,
    ``torch_train``'s own file-store rendezvous)."""
    conf, dirs = gangs2[name]
    check_gang(name, 2, conf, dirs)


def test_gang_missing_a_rank_exits_retryable_within_its_timeout(tmp_path):
    from kubeflow_tpu_torch.runtime.bootstrap import EXIT_RETRYABLE

    conf = _gang_config("llm_pretrain", tmp_path)
    t0 = time.monotonic()
    (rc, out, _), = finish(spawn_gang(
        "llm_pretrain", conf, 2, [tmp_path / "w0", tmp_path / "w1"],
        timeout_s=3.0, ranks=[0]), timeout=60)
    assert rc == EXIT_RETRYABLE, out
    assert "rendezvous failed" in out
    assert time.monotonic() - t0 < 30


def test_classify_exit_maps_torch_error_types():
    import torch.distributed as dist

    from kubeflow_tpu_torch.runtime.bootstrap import (
        EXIT_PERMANENT, EXIT_RETRYABLE,
    )
    from kubeflow_tpu_torch.runtime.worker_main import _classify_exit

    for exc in (dist.DistBackendError("nccl watchdog timeout"),
                dist.DistNetworkError("peer closed"),
                dist.DistStoreError("store timed out")):
        assert _classify_exit(exc) == EXIT_RETRYABLE, type(exc)

    class Mine(dist.DistBackendError):
        pass

    for exc in (torch.OutOfMemoryError("out of memory"),
                ValueError("shapes"), RuntimeError("DistBackendError"),
                Mine("a subclass is not the type"), KeyError("x")):
        assert _classify_exit(exc) == EXIT_PERMANENT, type(exc)


@pytest.mark.parametrize("name", ENTRYPOINTS)
def test_without_a_card_each_raises_unless_told_cpu(name, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    conf = {"llm_pretrain": _llm_config(str(tmp_path / "ck")),
            "vision_train": {"steps": 1},
            "torch_train": {"steps": 1}}[name]
    for platform in (None, "gpu"):
        ctx = WorkerContext(env=_wenv(name, conf, tmp_path,
                                      platform=platform))
        with pytest.raises(RuntimeError, match="KFTPU_PLATFORM"):
            resolve_entrypoint(name)(ctx)
    assert not (tmp_path / "metrics.jsonl").exists()
