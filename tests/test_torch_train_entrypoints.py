"""The port's training entry points through ``runtime.worker_main`` on the
CPU (``KFTPU_PLATFORM=cpu``):

- ``llm_pretrain`` on ``tiny-moe``: exit 0, one ``metrics.jsonl`` line per
  step with ``loss`` and ``aux_loss``, a checkpoint whose params load
  through ``load_params("file://…")`` (those of an in-process ``Trainer``
  run from the same config, within 1e-5) and serve;
- ``vision_train`` (ViT on ``tiny-vit``, CLIP on ``tiny-clip``) and
  ``torch_train``: exit 0, every ``metrics.jsonl`` value finite;
- the registry holds all three beside ``model_server``; a two-process
  world is refused with the multi-GPU pointer, and without a card and
  without ``cpu`` each entry point raises.
"""

import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

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


@pytest.mark.parametrize("name", ENTRYPOINTS)
def test_multi_process_world_is_refused(name, tmp_path):
    ctx = WorkerContext(env=_wenv(name, {}, tmp_path, num_processes=2))
    with pytest.raises(NotImplementedError, match="Queue 1 item 9"):
        resolve_entrypoint(name)(ctx)


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
