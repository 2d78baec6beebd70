"""The port's ``serve/storage.load_params`` on the CPU: ``random://`` is the
engine's seeded init, ``file://`` reads a port ``Trainer``'s checkpoint
(cast per config) and refuses a missing one, other schemes are refused —
and the parity gate: a tiny JAX ``Trainer`` run's orbax checkpoint served
by the JAX engine gives the same greedy tokens as the same params carried
across (``params_from_jax``), saved in the port's format, read by the
port's ``load_params`` and served by the port engine."""

import io

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from kubeflow_tpu.core.serving import BatchingSpec as JBatchingSpec  # noqa: E402
from kubeflow_tpu.models import config as jconfig  # noqa: E402
from kubeflow_tpu.runtime.mesh import build_mesh  # noqa: E402
from kubeflow_tpu.serve import engine as jengine  # noqa: E402
from kubeflow_tpu.serve import storage as jstorage  # noqa: E402
from kubeflow_tpu.train import trainer as jtrainer  # noqa: E402
from kubeflow_tpu_torch.core.serving import BatchingSpec  # noqa: E402
from kubeflow_tpu_torch.models.config import preset  # noqa: E402
from kubeflow_tpu_torch.models.convert import params_from_jax  # noqa: E402
from kubeflow_tpu_torch.models.decoder import init_decoder_params  # noqa: E402
from kubeflow_tpu_torch.serve import engine as E  # noqa: E402
from kubeflow_tpu_torch.serve.storage import load_params  # noqa: E402
from kubeflow_tpu_torch.train import tree as T  # noqa: E402
from kubeflow_tpu_torch.train.checkpoint import (  # noqa: E402
    CheckpointCorruptionError, CheckpointManager,
)
from kubeflow_tpu_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402

PROMPTS = ([5, 17, 3, 99, 42], [7] * 20, [30, 31, 200, 1])
SPEC = dict(max_batch_size=2, max_seq_len=64, prefill_buckets=[16, 64])


def _assert_trees_equal(a, b):
    fa, fb = T.flatten(a), T.flatten(b)
    assert list(fa) == list(fb)
    for k in fa:
        assert fa[k].dtype == fb[k].dtype, k
        assert torch.equal(fa[k], fb[k]), k


@pytest.mark.parametrize("uri", ["random://", None])
def test_random_scheme_is_the_seeded_init(uri):
    cfg = preset("tiny", dtype="float32")
    got = load_params(uri, cfg, seed=3, device="cpu")
    want = init_decoder_params(torch.Generator("cpu").manual_seed(3), cfg)
    _assert_trees_equal(got, want)
    other = load_params(uri, cfg, seed=4, device="cpu")
    assert not torch.equal(other["embed"], want["embed"])


def test_file_scheme_round_trips_a_port_trainer_run(tmp_path):
    ckpt = tmp_path / "ckpt"
    cfg = TrainerConfig(model="tiny", model_overrides={
        "dtype": "float32", "fused_kernels": "off"},
        data={"seq_len": 32, "global_batch": 4}, steps=4, log_every=1,
        checkpoint_dir=str(ckpt), checkpoint_every=2, max_checkpoints=2,
        watchdog_enabled=False)
    tr = Trainer(cfg, device="cpu", workdir=str(tmp_path / "work"))
    tr.emitter.stream = io.StringIO()
    tr.run()
    trained = tr.task.state["params"]
    serve_cfg = preset("tiny", dtype="float32")
    got = load_params(f"file://{ckpt}", serve_cfg, device="cpu")
    _assert_trees_equal(got, T.map_tree(lambda t: t.detach(), trained))
    # Cast per config: bf16 params in the serving config.
    got16 = load_params(f"file://{ckpt}",
                        preset("tiny", param_dtype="bfloat16"), device="cpu")
    _assert_trees_equal(got16, T.map_tree(
        lambda t: t.detach().to(torch.bfloat16), trained))


def test_missing_checkpoints_and_other_schemes_raise(tmp_path, monkeypatch):
    cfg = preset("tiny", dtype="float32")
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(FileNotFoundError, match="kubeflow_tpu_torch"):
        load_params(f"file://{empty}", cfg, device="cpu")
    missing = tmp_path / "missing"
    with pytest.raises(FileNotFoundError, match="kubeflow_tpu_torch"):
        load_params(f"file://{missing}", cfg, device="cpu")
    assert not missing.exists()
    # A torn params file fails its manifest check (only the params subtree
    # is read, and so checked); an optimizer file is never read.
    good = tmp_path / "good"
    tree = {"params": init_decoder_params(
        torch.Generator("cpu").manual_seed(0), cfg),
        "opt_state": {"mu": torch.zeros(3)}, "step": 1}
    CheckpointManager(str(good)).save(1, tree)
    with open(good / "1" / "opt_state.mu.pt", "ab") as f:
        f.write(b"x")
    _assert_trees_equal(load_params(f"file://{good}", cfg, device="cpu"),
                        tree["params"])
    with open(good / "1" / "params.embed.pt", "ab") as f:
        f.write(b"x")
    with pytest.raises(CheckpointCorruptionError, match="params.embed.pt"):
        load_params(f"file://{good}", cfg, device="cpu")
    with pytest.raises(ValueError, match="unsupported storageUri scheme"):
        load_params("s3://bucket/model", cfg, device="cpu")
    # artifact:// loads now (test_torch_artifacts.py); a name nobody
    # registered is missing, and no store at all is an error naming the env.
    with pytest.raises(FileNotFoundError, match="m0"):
        load_params("artifact://m0@1", cfg, device="cpu",
                    artifact_root=str(tmp_path / "store"))
    monkeypatch.delenv("KFTPU_ARTIFACT_ROOT", raising=False)
    with pytest.raises(RuntimeError, match="KFTPU_ARTIFACT_ROOT"):
        load_params("artifact://m0@1", cfg, device="cpu")


def test_jax_checkpoint_and_port_checkpoint_serve_the_same_tokens(tmp_path):
    """The parity gate across the format boundary: JAX ``file://`` (orbax)
    served by the JAX engine against port ``file://`` served by the port
    engine, identical greedy tokens."""
    jckpt = tmp_path / "jax_ckpt"
    jcfg_train = jtrainer.TrainerConfig(
        model="tiny", model_overrides={"dtype": "float32"},
        optimizer={"learning_rate": 3e-3, "warmup_steps": 1},
        data={"global_batch": 4, "seq_len": 32, "vocab_size": 256},
        steps=3, log_every=1, checkpoint_dir=str(jckpt), checkpoint_every=3,
        watchdog_enabled=False)
    mesh = build_mesh({"fsdp": 1}, jax.devices()[:1])
    jtrainer.Trainer(jcfg_train, mesh,
                     metrics_path=str(tmp_path / "m.jsonl")).run()
    jcfg = jconfig.preset("tiny", dtype="float32")
    jparams = jstorage.load_params(f"file://{jckpt}", jcfg)
    jeng = jengine.LLMEngine(jcfg, JBatchingSpec(**SPEC), params=jparams)
    want = [jeng.generate(p, jengine.SamplingParams(max_new_tokens=10))
            for p in PROMPTS]

    pckpt = tmp_path / "port_ckpt"
    tree = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    assert CheckpointManager(str(pckpt)).save(3, {"params": tree, "step": 3})
    cfg = preset("tiny", dtype="float32")
    params = load_params(f"file://{pckpt}", cfg, device="cpu")
    eng = E.LLMEngine(cfg, BatchingSpec(**SPEC), params=params, device="cpu")
    got = [eng.generate(p, E.SamplingParams(max_new_tokens=10))
           for p in PROMPTS]
    assert got == want
    assert any(len(set(g)) > 1 for g in got)
