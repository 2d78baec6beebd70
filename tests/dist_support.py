"""Multi-process gangs for the port's distributed tests: spawn ``n``
``runtime.worker_main`` processes as one gloo world on the CPU, and the
suites such a gang runs (``module:function`` entry points, this module on
their path). Imports no JAX: the workers load only the port."""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent


@contextlib.contextmanager
def one_thread():
    """Torch on one thread inside: tiny ops on a pool of threads spend
    their time contending with a gang's ranks (~30x slower here)."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_gang(entrypoint: str, config: dict, n: int, workdirs, *,
               parallelism: dict | None = None, timeout_s: float = 60.0,
               ranks=None) -> list[subprocess.Popen]:
    """``n``-process world of ``worker_main`` on the CPU (gloo), one
    thread each; ``ranks`` (default all) picks which ranks start."""
    from kubeflow_tpu_torch.runtime.bootstrap import WorkerEnv

    port = free_port()
    procs = []
    for r in (range(n) if ranks is None else ranks):
        wenv = WorkerEnv(
            coordinator_address=f"127.0.0.1:{port}", num_processes=n,
            process_id=r, job="default/gang", replica_index=r,
            entrypoint=entrypoint, config=config,
            parallelism=parallelism or {}, platform="cpu",
            workdir=str(workdirs[r]), rendezvous_timeout_seconds=timeout_s)
        env = {k: v for k, v in os.environ.items()
               if not k.startswith("KFTPU_")}
        env.update(wenv.to_env())
        env["PYTHONPATH"] = os.pathsep.join([str(REPO),
                                             str(REPO / "tests")])
        env["OMP_NUM_THREADS"] = "1"
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "kubeflow_tpu_torch.runtime.worker_main"],
            cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    return procs


def finish(procs, timeout: float = 240.0) -> list[tuple[int, str, str]]:
    """Every process's (exit code, stdout, stderr); kills the rest when one
    outlives ``timeout``."""
    out = []
    try:
        for p in procs:
            o, e = p.communicate(timeout=timeout)
            out.append((p.returncode, o, e))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return out


# -- checks of an entry point's gang -------------------------------------------

def _one_process_vision_loss(conf: dict) -> float:
    """The first step's loss of ``vision_train``'s task in one process on
    the same global batch."""
    from kubeflow_tpu_torch.models import vision as V
    from kubeflow_tpu_torch.train import vision_task as VT
    from kubeflow_tpu_torch.train.optim import OptimizerConfig

    family = conf["family"]
    preset_fn = V.vit_preset if family == "vit" else V.clip_preset
    mcfg = preset_fn(conf["model"], **conf["model_overrides"])
    setup = VT.setup_vit_train if family == "vit" else VT.setup_clip_train
    batch_fn = VT.vit_batch if family == "vit" else VT.clip_batch
    with one_thread():
        task = setup(mcfg, OptimizerConfig(total_steps=2, warmup_steps=0),
                     device="cpu")
        _, m = task.step_fn(task.state, batch_fn(mcfg, conf["batch"], 0))
    return float(m["loss"])


def check_gang(name: str, n: int, conf: dict, dirs) -> None:
    """An ``n``-rank gang of entry point ``name`` (workdirs ``dirs``):
    finite metrics from the coordinator alone; ``vision_train``'s first
    loss that of one process on the same batch; ``torch_train``'s loss
    falls and every rank ends on the coordinator's weights;
    ``llm_pretrain`` logs each step."""
    import torch

    rows = [json.loads(x) for x in
            (Path(dirs[0]) / "metrics.jsonl").read_text().splitlines()]
    assert rows and all(math.isfinite(v) for r in rows
                        for v in r.values())
    for d in dirs[1:]:
        assert not (Path(d) / "metrics.jsonl").exists()
    if name == "vision_train":
        want = _one_process_vision_loss(conf)
        assert abs(rows[0]["loss"] - want) <= 1e-5 * max(1.0, abs(want))
    if name == "torch_train":
        ref = torch.load(Path(dirs[0]) / "checkpoint.pt")
        for r in range(1, n):
            got = torch.load(Path(dirs[r]) / f"checkpoint.rank{r}.pt")
            assert all(torch.equal(got[k], ref[k]) for k in ref)
        losses = [r["loss"] for r in rows]
        assert losses[-1] < losses[0]
    if name == "llm_pretrain":
        assert [r["step"] for r in rows] == [1, 2]


# -- suites (run inside the gang's workers) ------------------------------------

#: name → (impl, causal, softcap) of the ring suite.
RING_CASES = {
    "ring_causal": ("xla", True, None),
    "ring_full": ("xla", False, None),
    "ring_softcap": ("xla", True, 2.0),
    "flash_causal": ("pallas", True, None),
    "flash_full": ("pallas", False, None),
    "flash_softcap": ("pallas", True, 2.0),
    "ulysses_causal": ("ulysses", True, None),
    "ulysses_full": ("ulysses", False, None),
    "ulysses_softcap": ("ulysses", True, 2.0),
}


def ring_suite(ctx) -> int:
    """On a ``{"seq": n}`` mesh: every ``RING_CASES`` case's local output,
    lse (the flash ring) and q/k/v gradients for the inputs and output
    cotangent in ``config["inputs"]`` (an .npz of whole tensors)."""
    import torch

    from kubeflow_tpu_torch.parallel import ring_attention as R

    torch.set_num_threads(1)
    mesh = ctx.mesh
    group, idx = mesh.get_group("seq"), mesh.get_local_rank("seq")
    n = mesh.size()
    data = np.load(ctx.config["inputs"])
    out = {}
    for name, (impl, causal, softcap) in RING_CASES.items():
        q, k, v, do = (torch.from_numpy(data[x]).chunk(n, dim=1)[idx]
                       .clone().requires_grad_(x != "do")
                       for x in ("q", "k", "v", "do"))
        lse = None
        if impl == "ulysses":
            o = R.ulysses_attention_sharded(q, k, v, mesh, causal=causal,
                                            logits_softcap=softcap)
        elif impl == "pallas":
            o, lse = R.ring_flash_attention(q, k, v, group, causal=causal,
                                            logits_softcap=softcap)
        else:
            o = R.ring_attention_sharded(q, k, v, mesh, causal=causal,
                                         logits_softcap=softcap, impl="xla")
        dq, dk, dv = torch.autograd.grad(o, (q, k, v), do)
        out[name] = {"o": o.detach(), "lse": lse, "dq": dq, "dk": dk,
                     "dv": dv}
    torch.save(out, os.path.join(ctx.config["out"], f"rank{idx}.pt"))
    return 0


#: name → (mesh axes, port attn_impl, fused_kernels) of the train suite:
#: "on" runs the fused norm, SwiGLU and CE (their plain versions on the
#: CPU) on each rank's local blocks.
TRAIN_CASES = {
    "fsdp4": ({"fsdp": 4}, "xla", "on"),
    "data2_fsdp2": ({"data": 2, "fsdp": 2}, "xla", "off"),
    "data2_seq2": ({"data": 2, "seq": 2}, "ring_flash", "on"),
    "seq4": ({"seq": 4}, "ring", "off"),
}
#: The case whose run checkpoints (steps 2, 4 and 5).
CKPT_CASE = "data2_fsdp2"
STEPS = 5


#: The entry points the train suite also runs on its world (the mesh the
#: gang's bootstrap built, ``{fsdp: 4}``), and their configs.
ENTRY_CONFIGS = {
    "llm_pretrain": {"model": "tiny", "steps": 2, "log_every": 1,
                     "model_overrides": {"dtype": "float32", "n_layers": 1},
                     "data": {"seq_len": 32, "global_batch": 4},
                     "watchdog_enabled": False},
    "vision_train": {"family": "clip", "model": "tiny-clip", "steps": 2,
                     "batch": 4, "model_overrides": {"dtype": "float32"}},
    "torch_train": {"steps": 4, "batch": 8},
}


def entry_dirs(base, name: str, n: int) -> list[Path]:
    return [Path(base) / "entry" / name / "job" / f"worker-{r}"
            for r in range(n)]


def train_config(attn: str, ckpt=None, fused: str = "off") -> dict:
    """The TrainerConfig fields of every run the distributed tests compare
    (tiny, fp32, 5 steps, 4 x 32 tokens a step)."""
    return {"model": "tiny",
            "model_overrides": {"dtype": "float32", "fused_kernels": fused},
            "data": {"seq_len": 32, "global_batch": 4}, "steps": STEPS,
            "log_every": 1, "attn_impl": attn,
            "optimizer": {"learning_rate": 3e-3, "warmup_steps": 1},
            "watchdog_enabled": False, "checkpoint_dir": ckpt,
            "checkpoint_every": 2 if ckpt else 0, "max_checkpoints": 3,
            "emergency_checkpointing": False}


def train_suite(ctx) -> int:
    """Each ``TRAIN_CASES`` mesh over the gang's world: a ``Trainer`` run
    of 5 steps; this rank's init shards, local batch of every step, losses
    and grad norms, its state after step 1 (and, in the checkpointing case,
    after steps 2 and 5), the sharded and whole global norm of a
    seeded tree, and which ranks wrote manifests; then the checkpoint's
    step 4 resumed on ``{fsdp: 4}``, and the three training entry points
    (``run_entrypoints``)."""
    import torch

    from kubeflow_tpu_torch.runtime.mesh import build_mesh
    from kubeflow_tpu_torch.train import checkpoint as C
    from kubeflow_tpu_torch.train import tree as T
    from kubeflow_tpu_torch.train.optim import global_norm
    from kubeflow_tpu_torch.train.trainer import Trainer, TrainerConfig

    torch.set_num_threads(1)
    ctx.mesh                                   # join the world
    rank, world = ctx.env.process_id, ctx.env.num_processes
    base = Path(ctx.config["out"])
    write_manifest = C.CheckpointManager._write_manifest

    def logged(self, step, files):
        with open(base / "manifest_writers.txt", "a") as f:
            f.write(f"{rank}\n")
        return write_manifest(self, step, files)

    C.CheckpointManager._write_manifest = logged
    out = {}
    for name, (axes, attn, fused) in TRAIN_CASES.items():
        mesh = build_mesh(axes, "cpu")
        wd = base / name / f"rank{rank}"
        wd.mkdir(parents=True, exist_ok=True)
        ckpt = str(base / "ckpt") if name == CKPT_CASE else None
        tr = Trainer(TrainerConfig.from_dict(train_config(attn, ckpt, fused)),
                     mesh, process_id=rank, num_processes=world, device="cpu",
                     metrics_path=str(wd / "metrics.jsonl"),
                     workdir=str(wd))
        rec = {"init": T.map_tree(lambda t: t.detach().clone(),
                                  tr.task.state["params"]),
               "batches": [tr.data.batch_at(s) for s in range(STEPS)],
               "losses": [], "grad_norms": []}

        def on_step(step, m, tr=tr, rec=rec, name=name):
            rec["losses"].append(m["loss"])
            rec["grad_norms"].append(m["grad_norm"])
            if step == 1 or (name == CKPT_CASE and step in (2, STEPS)):
                rec[f"state{step}"] = T.map_tree(
                    lambda t: t.detach().clone()
                    if isinstance(t, torch.Tensor) else t, tr.task.state)

        tr.run(on_step=on_step)
        layout = tr.task.layout
        specs = T.flatten(layout.specs)
        blocks = C.ShardLayout(layout.sizes, layout.coords, specs)
        gen = torch.Generator().manual_seed(7)
        full = T.unflatten({
            p: torch.randn(blocks.global_shape(p, t.shape), generator=gen)
            for p, t in T.flatten(rec["init"]).items()})
        rec["norm_sharded"] = float(layout.global_norm(layout.cut(full)))
        rec["norm_whole"] = float(global_norm(full))
        rec["specs"] = specs
        rec["coords"] = layout.coords
        out[name] = rec
    # Resume the checkpointing case's step 4 on another mesh with the same
    # four batch shards ({fsdp: 4}: its blocks split in four, the saved
    # ones in two) and run step 5 again.
    import shutil

    import torch.distributed as dist

    again = base / "ckpt_resume"
    if rank == 0:
        shutil.copytree(base / "ckpt", again)
        shutil.rmtree(again / str(STEPS))
        (again / "manifests" / f"{STEPS}.json").unlink()
    dist.barrier()
    tr = Trainer(TrainerConfig.from_dict(train_config("xla", str(again))),
                 build_mesh({"fsdp": 4}, "cpu"), process_id=rank,
                 num_processes=world, device="cpu")
    resumed = {}
    tr.run(on_step=lambda step, m: resumed.__setitem__(step, m["loss"]))
    out["resumed"] = resumed
    torch.save(out, base / f"rank{rank}.pt")
    run_entrypoints(ctx, base)
    return 0


def run_entrypoints(ctx, base) -> None:
    """The three training entry points on the suite's world of ranks:
    ``llm_pretrain`` and ``vision_train`` (CLIP: one row a rank) on the
    mesh the worker joined; then the worker leaves it and ``torch_train``
    makes its own gloo group through its file store."""
    from kubeflow_tpu_torch.runtime.bootstrap import shutdown_worker
    from kubeflow_tpu_torch.runtime.entrypoints import (
        WorkerContext, resolve_entrypoint,
    )

    rank, n = ctx.env.process_id, ctx.env.num_processes
    for name in ("llm_pretrain", "vision_train", "torch_train"):
        if name == "torch_train":
            shutdown_worker()
        wd = entry_dirs(base, name, n)[rank]
        wd.mkdir(parents=True, exist_ok=True)
        env = dataclasses.replace(ctx.env, entrypoint=name,
                                  config=ENTRY_CONFIGS[name], workdir=str(wd))
        assert resolve_entrypoint(name)(WorkerContext(env=env)) == 0
