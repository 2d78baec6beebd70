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
    over = dict(conf["model_overrides"])
    image = over.pop("image", None)
    preset_fn = V.vit_preset if family == "vit" else V.clip_preset
    mcfg = preset_fn(conf["model"], **over)
    if image:
        mcfg = dataclasses.replace(
            mcfg, image=dataclasses.replace(mcfg.image, **image))
    setup = VT.setup_vit_train if family == "vit" else VT.setup_clip_train
    batch_fn = VT.vit_batch if family == "vit" else VT.clip_batch
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


def train_config(attn: str, ckpt=None, fused: str = "off",
                 chunk: int = 0, model: str = "tiny", **over) -> dict:
    """The TrainerConfig fields of every run the distributed tests compare
    (tiny, fp32, 5 steps, 4 x 32 tokens a step; ``chunk`` the CE's
    ``loss_chunk_size``; ``model`` and ``over``: another preset and more
    overrides)."""
    return {"model": model,
            "model_overrides": {"dtype": "float32", "fused_kernels": fused,
                                "loss_chunk_size": chunk, **over},
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


# -- tensor parallelism over the model axis ------------------------------------

#: name → (mesh axes, port attn_impl, fused_kernels, loss_chunk_size) of the
#: TP suite, by world size: the fused CE ("on": its plain kernels on the
#: CPU), the chunked CE (chunk 8) and the dense CE each run vocab-parallel;
#: ``model4`` has tiny's 2 kv heads whole on every rank.
TP_CASES = {
    2: {"model2": ({"model": 2}, "xla", "off", 0)},
    4: {"model4": ({"model": 4}, "xla", "on", 0),
        "fsdp2_model2": ({"fsdp": 2, "model": 2}, "xla", "off", 8),
        "data2_model2": ({"data": 2, "model": 2}, "xla", "on", 0),
        "seq2_model2": ({"seq": 2, "model": 2}, "ring_flash", "off", 0)},
}
#: The TP case whose run checkpoints (steps 2, 4 and 5).
TP_CKPT_CASE = "fsdp2_model2"


def tp_tokens(seed: int = 11) -> np.ndarray:
    """The global batch of the TP suite's loss-and-gradient check: [4, 33]
    token ids of tiny's vocabulary."""
    return np.random.default_rng(seed).integers(0, 256, (4, 33))


def tp_suite(ctx) -> int:
    """Each ``TP_CASES`` mesh of the gang's world size: this rank's loss,
    metrics and synced gradients of ``decoder_loss`` on the init and
    ``tp_tokens`` (its batch rows), then a ``Trainer`` run of 5 steps
    (losses, grad norms, its state after step 1, and in the checkpointing
    case the checkpoint), with the leaves' specs and this rank's
    coordinates."""
    import torch

    from kubeflow_tpu_torch.models.decoder import decoder_loss
    from kubeflow_tpu_torch.parallel.fsdp import batch_index
    from kubeflow_tpu_torch.runtime.mesh import build_mesh
    from kubeflow_tpu_torch.train import tree as T
    from kubeflow_tpu_torch.train.trainer import Trainer, TrainerConfig

    torch.set_num_threads(1)
    ctx.mesh                                   # join the world
    rank, world = ctx.env.process_id, ctx.env.num_processes
    base = Path(ctx.config["out"])
    out = {}
    for name, (axes, attn, fused, chunk) in TP_CASES[world].items():
        mesh = build_mesh(axes, "cpu")
        wd = base / name / f"rank{rank}"
        wd.mkdir(parents=True, exist_ok=True)
        ckpt = str(base / "ckpt") if name == TP_CKPT_CASE else None
        tr = Trainer(TrainerConfig.from_dict(
            train_config(attn, ckpt, fused, chunk)), mesh, process_id=rank,
            num_processes=world, device="cpu", workdir=str(wd))
        task = tr.task
        params = task.state["params"]
        rec = {"init": T.map_tree(lambda t: t.detach().clone(), params),
               "specs": T.flatten(task.layout.specs),
               "coords": task.layout.coords, "losses": [], "grad_norms": []}
        idx, dp = batch_index(mesh)
        toks = torch.from_numpy(tp_tokens())
        rows = toks.shape[0] // dp
        loss, m = decoder_loss(params, toks[idx * rows:(idx + 1) * rows],
                               task.cfg, attn_impl=attn, mesh=mesh,
                               placements=task.layout.dims)
        grads = list(torch.autograd.grad(loss, T.leaves(params)))
        task.layout.sync_grads(grads)
        rec["ce_loss"], rec["accuracy"] = float(m["ce_loss"]), float(
            m["accuracy"])
        rec["grads"] = T.unflatten(dict(zip(T.flatten(params), grads)))

        def on_step(step, m, tr=tr, rec=rec, name=name):
            rec["losses"].append(m["loss"])
            rec["grad_norms"].append(m["grad_norm"])
            if step == 1:
                rec["params1"] = T.map_tree(lambda t: t.detach().clone(),
                                            tr.task.state["params"])
            if name == TP_CKPT_CASE and step == 2:
                rec["state2"] = T.map_tree(
                    lambda t: t.detach().clone()
                    if isinstance(t, torch.Tensor) else t, tr.task.state)

        tr.run(on_step=on_step)
        out[name] = rec
    torch.save(out, base / f"rank{rank}.pt")
    return 0


def whole_tree(recs: list, get) -> dict:
    """Flattened whole tree of ``get(record)`` assembled from the ranks'
    records (their local blocks, ``specs`` and ``coords``)."""
    from kubeflow_tpu_torch.parallel.sharding import assemble
    from kubeflow_tpu_torch.train import tree as T
    from kubeflow_tpu_torch.train.checkpoint import ShardLayout

    sizes = {a: 1 for a in recs[0]["coords"]}
    for rec in recs:
        for a, c in rec["coords"].items():
            sizes[a] = max(sizes[a], c + 1)
    specs = recs[0]["specs"]
    blocks = ShardLayout(sizes, {}, specs)
    local = [T.flatten(get(rec)) for rec in recs]
    out = {}
    for p, spec in specs.items():
        def shard_of(c, p=p):
            for rec, loc in zip(recs, local):
                if all(rec["coords"][a] == v for a, v in c.items()):
                    return loc[p]
            raise KeyError(c)

        out[p] = assemble(blocks.global_shape(p, local[0][p].shape), spec,
                          sizes, shard_of)
    return out


# -- MoE on a mesh -------------------------------------------------------------

#: name → (mesh axes, port attn_impl, fused_kernels, loss_chunk_size,
#: tiny-moe overrides) of the MoE suite (4 ranks): one expert a rank;
#: a batch split whose capacity binds (factor 0.5: 32 slots an expert of
#: the global batch's 256 pairs, where a plan of each rank's 128 pairs
#: alone would give 16); expert leaves split on two dims (E over expert,
#: D over fsdp); the flash ring under seq (``block_outs`` remat); experts
#: over expert and their columns over model (``dots_saveable`` remat); a
#: batch and sequence split with no expert axis and binding capacity.
MOE_CASES = {
    "expert4": ({"expert": 4}, "xla", "on", 0, {}),
    "data2_expert2": ({"data": 2, "expert": 2}, "xla", "off", 0,
                      {"capacity_factor": 0.5}),
    "fsdp2_expert2": ({"fsdp": 2, "expert": 2}, "xla", "off", 8, {}),
    "seq2_expert2": ({"seq": 2, "expert": 2}, "ring_flash", "off", 0,
                     {"remat_policy": "block_outs"}),
    "expert2_model2": ({"expert": 2, "model": 2}, "xla", "off", 0,
                       {"remat_policy": "dots_saveable"}),
    "data2_seq2": ({"data": 2, "seq": 2}, "xla", "off", 0,
                   {"capacity_factor": 0.5}),
}
#: The MoE case whose run checkpoints (steps 2, 4 and 5).
MOE_CKPT_CASE = "fsdp2_expert2"
#: The case whose loss and gradients are also taken on the dense path.
MOE_DENSE_CASE = "expert4"


def moe_suite(ctx) -> int:
    """Each ``MOE_CASES`` mesh over the gang's 4 ranks, ``tiny-moe`` in
    fp32: this rank's loss, metrics, synced gradients and dispatch plans'
    kept pairs (per layer, the forward's) of ``decoder_loss`` on the
    init and ``tp_tokens`` (its batch rows), and in ``MOE_DENSE_CASE``
    the same on the dense path; then a ``Trainer`` run of 5 steps (losses,
    aux losses, grad norms, its state after step 1, and in the
    checkpointing case the checkpoint), with the leaves' specs and this
    rank's coordinates."""
    import dataclasses

    import torch

    from kubeflow_tpu_torch.models import layers as L
    from kubeflow_tpu_torch.models.decoder import decoder_loss
    from kubeflow_tpu_torch.parallel.fsdp import batch_index
    from kubeflow_tpu_torch.runtime.mesh import build_mesh
    from kubeflow_tpu_torch.train import tree as T
    from kubeflow_tpu_torch.train.trainer import Trainer, TrainerConfig

    torch.set_num_threads(1)
    ctx.mesh                                   # join the world
    rank, world = ctx.env.process_id, ctx.env.num_processes
    base = Path(ctx.config["out"])
    plan_of = L.dispatch_plan
    keeps: list = []

    def recorded(*args, **kwargs):
        plan = plan_of(*args, **kwargs)
        keeps.append(plan["keep"].clone())
        return plan

    L.dispatch_plan = recorded
    out = {}
    for name, (axes, attn, fused, chunk, over) in MOE_CASES.items():
        mesh = build_mesh(axes, "cpu")
        wd = base / name / f"rank{rank}"
        wd.mkdir(parents=True, exist_ok=True)
        ckpt = str(base / "ckpt") if name == MOE_CKPT_CASE else None
        tr = Trainer(TrainerConfig.from_dict(train_config(
            attn, ckpt, fused, chunk, "tiny-moe", **over)), mesh,
            process_id=rank, num_processes=world, device="cpu",
            workdir=str(wd))
        task = tr.task
        params = task.state["params"]
        rec = {"init": T.map_tree(lambda t: t.detach().clone(), params),
               "specs": T.flatten(task.layout.specs),
               "coords": task.layout.coords, "losses": [], "aux": [],
               "grad_norms": []}
        idx, dp = batch_index(mesh)
        toks = torch.from_numpy(tp_tokens())
        rows = toks.shape[0] // dp
        impls = ["dispatch"] + (["dense"] if name == MOE_DENSE_CASE else [])
        for impl in impls:
            cfg = dataclasses.replace(task.cfg, moe_impl=impl)
            keeps.clear()
            loss, m = decoder_loss(params, toks[idx * rows:(idx + 1) * rows],
                                   cfg, attn_impl=attn, mesh=mesh,
                                   placements=task.layout.dims)
            grads = list(torch.autograd.grad(loss, T.leaves(params)))
            task.layout.sync_grads(grads)
            rec[impl] = {
                "ce_loss": float(m["ce_loss"]),
                "aux_loss": float(m["aux_loss"]),
                "accuracy": float(m["accuracy"]),
                "keeps": keeps[:cfg.n_layers],
                "grads": T.unflatten(dict(zip(T.flatten(params), grads)))}

        def on_step(step, m, tr=tr, rec=rec, name=name):
            rec["losses"].append(m["loss"])
            rec["aux"].append(m["aux_loss"])
            rec["grad_norms"].append(m["grad_norm"])
            if step == 1:
                rec["params1"] = T.map_tree(lambda t: t.detach().clone(),
                                            tr.task.state["params"])
            if name == MOE_CKPT_CASE and step == 2:
                rec["state2"] = T.map_tree(
                    lambda t: t.detach().clone()
                    if isinstance(t, torch.Tensor) else t, tr.task.state)

        tr.run(on_step=on_step)
        out[name] = rec
    torch.save(out, base / f"rank{rank}.pt")
    return 0


#: name → BatchingSpec fields of the TP engine suite's engines (tiny's
#: 4 heads / 2 kv heads): the contiguous cache, the page pool with prefix
#: reuse and a copy-on-write tail (8-token pages; the prompts share a
#: 9-token prefix), int8 pages, and int8 weights.
TP_ENGINE_CASES = {
    "contiguous": dict(max_batch_size=2, max_seq_len=64,
                       prefill_buckets=[16, 32], decode_steps=4),
    "paged": dict(max_batch_size=2, max_seq_len=64, paged=True,
                  page_size=8, chunked_prefill_tokens=16, decode_steps=4),
    "paged_int8": dict(max_batch_size=2, max_seq_len=64, paged=True,
                       page_size=8, chunked_prefill_tokens=16,
                       decode_steps=4, kv_cache_dtype="int8"),
    "int8_weights": dict(max_batch_size=2, max_seq_len=64,
                         prefill_buckets=[16, 32], decode_steps=4,
                         weights_dtype="bfloat16", quantize="int8"),
}
#: The suite's prompts, in turn; their greedy and sampled completions.
TP_PROMPTS = ([3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5],
              [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8, 9, 7, 9, 3, 2, 3, 8],
              [3, 1, 4, 1, 5, 9, 2, 6, 7])
TP_TEMPS = (0.0, 0.8)


def tp_generate(eng) -> dict:
    """``TP_PROMPTS`` through ``eng`` at each of ``TP_TEMPS`` (top-k 20
    when sampling), one after another: temperature → completions."""
    from kubeflow_tpu_torch.serve.engine import SamplingParams

    return {t: [eng.generate(p, SamplingParams(
        max_new_tokens=10, temperature=t, top_k=20 if t else 0))
        for p in TP_PROMPTS] for t in TP_TEMPS}


def tp_shards(params: dict, cfg, spec: dict, mesh) -> dict:
    """This rank's shards of the whole ``params`` for an engine of
    ``spec`` on ``mesh``: cast to its ``weights_dtype`` and packed whole
    under its ``quantize``, then cut (``decoder_layout``), as
    ``serve.storage.load_params(mesh=)`` hands them to ``model_server``."""
    import torch

    from kubeflow_tpu_torch.models.decoder import decoder_layout
    from kubeflow_tpu_torch.ops.quantization import quantize_params_int8
    from kubeflow_tpu_torch.train import tree as T

    if spec.get("weights_dtype"):
        dt = getattr(torch, spec["weights_dtype"])
        params = T.map_tree(lambda t: t.to(dt), params)
    if spec.get("quantize"):
        params = quantize_params_int8(params, cfg)
    return decoder_layout(cfg, mesh).cut(params)


def tp_engine_suite(ctx) -> int:
    """Each ``TP_ENGINE_CASES`` engine on ``{model: world}`` over this
    rank's shards (``tp_shards``) of the whole params in
    ``config["params"]`` (a torch save) of ``config["model"]`` (default
    tiny) in fp32, seed 3: rank 0 runs ``tp_generate`` and stops the
    engine, the others ``follow``; each rank writes its ops (in all and by
    name), its generator's state after, and (rank 0) the completions and
    the engine's radix counters; and, under ``unpacked``, the error of an
    int8 engine given unpacked shards."""
    import torch

    from kubeflow_tpu_torch.core.serving import BatchingSpec
    from kubeflow_tpu_torch.models.config import preset
    from kubeflow_tpu_torch.models.decoder import decoder_layout
    from kubeflow_tpu_torch.serve.engine import LLMEngine

    torch.set_num_threads(1)
    mesh = ctx.mesh
    rank = ctx.env.process_id
    params = torch.load(ctx.config["params"])
    cfg = preset(ctx.config.get("model", "tiny"), dtype="float32")
    out = {}
    try:
        LLMEngine(cfg, BatchingSpec(**TP_ENGINE_CASES["int8_weights"]),
                  params=decoder_layout(cfg, mesh).cut(params),
                  device="cpu", mesh=mesh)
    except ValueError as e:
        out["unpacked"] = str(e)
    for name, spec in TP_ENGINE_CASES.items():
        eng = LLMEngine(cfg, BatchingSpec(**spec),
                        params=tp_shards(params, cfg, spec, mesh),
                        device="cpu", mesh=mesh, seed=3)
        rec = {}
        if rank == 0:
            rec["tokens"] = tp_generate(eng)
            rec["kv_tier"] = eng.kv_tier_stats()
            eng.stop()
        else:
            eng.follow()
        rec["ops"], rec["by_op"] = eng.dispatches, dict(
            eng._dispatch.by_op)
        rec["gen"] = eng._gen.get_state()
        out[name] = rec
    torch.save(out, Path(ctx.config["out"]) / f"rank{rank}.pt")
    return 0


#: The roles suite's layouts (``TP_ENGINE_CASES``' first three): the
#: contiguous cache, full-dtype pages with prefix reuse and a COW tail,
#: int8 pages.
ROLE_CASES = {"dense": TP_ENGINE_CASES["contiguous"],
              "paged": TP_ENGINE_CASES["paged"],
              "paged_int8": TP_ENGINE_CASES["paged_int8"]}
#: The paged layouts, which run the tiers.
TIER_CASES = ("paged", "paged_int8")
#: The tiers' conversation: turn 1 fills 4 pages of 8, turn 2 extends it.
TIER_PROMPT = list(range(20, 52))
TIER_TURN2 = TIER_PROMPT + [7, 7, 3]
#: The tiers' knobs: demotion and spills only when forced (a drain), and a
#: store deadline a loaded CPU meets.
TIER_SPEC = dict(host_kv_pages=16, kv_demote_after_s=600.0,
                 kv_remote_deadline_s=30.0)
#: Greedy decode budget of every roles request.
ROLE_NEW = 10


def role_engines(kv_root) -> list[tuple[str, str, dict]]:
    """The TP engines of ``tp_roles_suite``, in the order every rank builds
    them: (step, layout, BatchingSpec fields)."""
    out = [("prefill", c, dict(s, role="prefill"))
           for c, s in ROLE_CASES.items()]
    out += [("tiers", c, dict(ROLE_CASES[c], role="prefill", **TIER_SPEC,
                              remote_kv_root=str(Path(kv_root, c + "-a"))))
            for c in TIER_CASES]
    out += [("remote_in", c, dict(ROLE_CASES[c], **TIER_SPEC,
                                  remote_kv_root=str(Path(kv_root, c + "-b"))))
            for c in TIER_CASES]
    out += [("decode", c, dict(s, role="decode"))
            for c, s in ROLE_CASES.items()]
    return out


def drive(eng, req, timeout: float = 120.0):
    """Step ``eng`` until ``req`` is done."""
    import time

    deadline = time.monotonic() + timeout
    while not req.done.is_set():
        eng.step()
        assert time.monotonic() < deadline, "request never finished"
    return req


def settle(eng, timeout: float = 60.0) -> dict:
    """Step ``eng`` until no page is referenced, no handoff held and no
    round in flight; its page books then (pages in use, leaks by owner,
    and whether the allocator is quiescent)."""
    import time

    deadline = time.monotonic() + timeout
    eng.step()                  # applies acks and fails queued so far
    while eng.kv_pages_in_use() or eng._handoff_holds or eng._rounds:
        eng.step()
        assert time.monotonic() < deadline, "engine did not quiesce"
    books = {"in_use": eng.kv_pages_in_use(), "leaks": {},
             "quiescent": True}
    if eng._allocator is not None:
        books["leaks"] = eng._allocator.leak_report_by_owner()
        try:
            eng._allocator.assert_quiescent()
        except AssertionError:
            books["quiescent"] = False
    return books


def chain_blobs(eng, tokens) -> list:
    """The host or remote tier entries (wire blobs; ``cas://`` uris once
    spilled) of ``tokens``' full blocks, in path order, from ``eng``'s
    radix tree."""
    pg, node, out = eng.page_size, eng._kvtier.root(""), []
    for i in range(len(tokens) // pg):
        node = node.children.get(tuple(tokens[i * pg:(i + 1) * pg]))
        if node is None:
            break
        out.append(node.blob)
    return out


def wait_file(path, timeout: float = 400.0):
    """The pickle at ``path`` once another process has written it."""
    import pickle
    import time

    deadline = time.monotonic() + timeout
    while not Path(path).exists():
        assert time.monotonic() < deadline, f"{path} never appeared"
        time.sleep(0.2)
    with open(path, "rb") as f:
        return pickle.load(f)


def write_pickle(path, obj) -> None:
    """``obj`` pickled to ``path``, which appears whole (rename)."""
    import pickle

    tmp = Path(str(path) + ".tmp")
    with open(tmp, "wb") as f:
        pickle.dump(obj, f)
    tmp.rename(path)


class _RolesLeader:
    """Rank 0 of ``tp_roles_suite``: the one-process references on the
    whole params, and each TP engine's requests."""

    def __init__(self, params, cfg, conf):
        from kubeflow_tpu_torch.serve.engine import SamplingParams

        self.params, self.cfg, self.conf = params, cfg, conf
        self.greedy = SamplingParams(max_new_tokens=ROLE_NEW)
        self.tp_wires: dict = {}
        # One-process references: unified tokens and prefill exports.
        self.unified, self.one_wires = {}, {}
        for c, spec in ROLE_CASES.items():
            uni = self.engine(spec)
            self.unified[c] = [uni.generate(p, self.greedy)
                               for p in TP_PROMPTS + (TIER_TURN2,)]
            pre = self.engine(dict(spec, role="prefill"))
            self.one_wires[c] = []
            for p in TP_PROMPTS:
                r = drive(pre, pre.submit(p, self.greedy))
                self.one_wires[c].append(r.handoff.to_wire())
                pre.complete_handoff(r.id)

    def engine(self, spec: dict):
        from kubeflow_tpu_torch.core.serving import BatchingSpec
        from kubeflow_tpu_torch.serve.engine import LLMEngine

        return LLMEngine(self.cfg, BatchingSpec(**spec), params=self.params,
                         device="cpu", seed=3)

    def adopt_all(self, eng, wires) -> list:
        from kubeflow_tpu_torch.serve.handoff import HandoffPayload

        out = []
        for w in wires:
            p = HandoffPayload.from_wire(w)
            r = drive(eng, eng.submit_handoff(p))
            out.append([p.first_token] + r.output_tokens)
        return out

    def prefill(self, eng, c: str) -> dict:
        """Each prompt exported (the slot and pages each export read
        recorded), then the first acked, the second failed and the third
        reaped; a one-process decode engine adopts the exports."""
        seen = []
        export = eng._export_handoff

        def spy(slot_idx):
            seen.append((slot_idx, list(eng._slot_pages[slot_idx])
                         if eng.paged else None))
            export(slot_idx)

        eng._export_handoff = spy
        reqs = [drive(eng, eng.submit(p, self.greedy)) for p in TP_PROMPTS]
        rec = {"reasons": [r.finish_reason for r in reqs],
               "held": eng.kv_pages_in_use(), "export_at": seen}
        self.tp_wires[c] = rec["wires"] = [r.handoff.to_wire() for r in reqs]
        eng.complete_handoff(reqs[0].id)
        eng.fail_handoff(reqs[1].id)
        reqs[2].cancel()
        rec["books"] = settle(eng)
        rec["metrics"] = eng.metrics.snapshot()
        one = self.engine(dict(ROLE_CASES[c], role="decode"))
        rec["one_from_tp"] = self.adopt_all(one, rec["wires"])
        rec["one_books"] = settle(one)
        return rec

    def tiers(self, eng, c: str) -> dict:
        """Turn 1 exported and acked, then demoted (forced); a one-process
        engine that adopts the same export demotes it too; turn 2 on the
        TP engine promotes from the host; a drain spills to the store, and
        a one-process engine on that store serves turn 2 from it."""
        rec = {}
        r = drive(eng, eng.submit(TIER_PROMPT, self.greedy))
        wire = r.handoff.to_wire()
        eng.complete_handoff(r.id)
        settle(eng)
        rec["demoted"] = eng._kvtier.tick(force=True)
        eng._kvtier.drain_migrations()
        rec["blobs_tp"] = chain_blobs(eng, TIER_PROMPT)
        one = self.engine(dict(ROLE_CASES[c], role="decode",
                               **TIER_SPEC))
        self.adopt_all(one, [wire])
        settle(one)
        one._kvtier.tick(force=True)
        one._kvtier.drain_migrations()
        rec["blobs_one"] = chain_blobs(one, TIER_PROMPT)
        one.stop()
        rec["host_tokens"] = drive(eng, eng.submit(
            TIER_TURN2, self.greedy, handoff=False)).output_tokens
        rec["host_stats"] = eng.kv_tier_stats()
        settle(eng)
        rec["published"] = eng.drain_kv_to_remote()
        rec["books"] = settle(eng)
        far = self.engine(dict(ROLE_CASES[c], **TIER_SPEC, remote_kv_root=str(
            Path(self.conf["kv_root"], c + "-a"))))
        rec["remote_tokens"] = far.generate(TIER_TURN2, self.greedy)
        rec["remote_stats"] = far.kv_tier_stats()
        far.stop()
        return rec

    def remote_in(self, eng, c: str) -> dict:
        """A one-process engine serves turn 1 and drains it to the store;
        the TP engine serves turn 2 from the store."""
        near = self.engine(dict(ROLE_CASES[c], **TIER_SPEC, remote_kv_root=str(
            Path(self.conf["kv_root"], c + "-b"))))
        near.generate(TIER_PROMPT, self.greedy)
        rec = {"published": near.drain_kv_to_remote()}
        near.stop()
        rec["remote_tokens"] = eng.generate(TIER_TURN2, self.greedy)
        rec["remote_stats"] = eng.kv_tier_stats()
        rec["books"] = settle(eng)
        return rec

    def decode(self, eng, c: str) -> dict:
        """The TP decode engine adopts its own gang's exports, the
        one-process engine's and JAX's TP engine's."""
        jax_tp = wait_file(self.conf["jax_tp"])
        rec = {src: self.adopt_all(eng, wires) for src, wires in (
            ("tp", self.tp_wires[c]), ("one", self.one_wires[c]),
            ("jax_tp", jax_tp[c]))}
        rec["books"] = settle(eng)
        rec["metrics"] = eng.metrics.snapshot()
        return rec


def tp_roles_suite(ctx) -> int:
    """The engines of ``role_engines`` on ``{model: world}`` over this
    rank's shards of the whole params in ``config["params"]`` (``tiny``,
    fp32): rank 0 drives each (``_RolesLeader``) and stops it, the others
    ``follow``. Every rank writes, per engine, its ops by name and (the
    prefill engines) its cache planes; rank 0 adds what it measured, and
    after the prefill engines writes their exports to ``exports.pkl`` for
    the JAX helper. ``config["jax_tp"]``: where JAX's TP exports appear."""
    import torch

    from kubeflow_tpu_torch.core.serving import BatchingSpec
    from kubeflow_tpu_torch.models.config import preset
    from kubeflow_tpu_torch.serve.engine import LLMEngine

    torch.set_num_threads(1)
    mesh = ctx.mesh
    rank = ctx.env.process_id
    conf = ctx.config
    out = Path(conf["out"])
    params = torch.load(conf["params"])
    cfg = preset("tiny", dtype="float32")
    leader = _RolesLeader(params, cfg, conf) if rank == 0 else None
    recs = {}
    for step, c, spec in role_engines(conf["kv_root"]):
        eng = LLMEngine(cfg, BatchingSpec(**spec),
                        params=tp_shards(params, cfg, spec, mesh),
                        device="cpu", mesh=mesh, seed=3)
        rec = {}
        if leader is not None:
            rec = getattr(leader, step)(eng, c)
            eng.stop()
        else:
            assert eng._kvtier is None
            eng.follow()
        rec["ops"], rec["by_op"] = eng.dispatches, dict(eng._dispatch.by_op)
        if step == "prefill":
            rec["planes"] = {n: t.clone() for n, t in eng.cache.items()}
        recs[step, c] = rec
        if leader is not None and step == "prefill" and \
                len(leader.tp_wires) == len(ROLE_CASES):
            write_pickle(out / "exports.pkl", leader.tp_wires)
    if leader is not None:
        recs["unified"] = leader.unified
        recs["one_wires"] = leader.one_wires
    torch.save(recs, out / f"rank{rank}.pt")
    return 0


class IdText:
    """A tokenizer that writes token ids as decimal text (``module:factory``
    ``dist_support:IdText``), so a server's completions read back as the
    engine's ids."""

    eos_id = None

    def encode(self, text: str) -> list[int]:
        return [int(x) for x in text.split()]

    def decode(self, ids: list[int]) -> str:
        return "".join(f" {i}" for i in ids)


# -- explainers under a tensor-parallel engine ---------------------------------

#: The explain suite's presets and prompts (token ids of their vocabulary).
EXPLAIN_PRESETS = ("tiny", "tiny-moe")
EXPLAIN_PROMPTS = ([3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8],
                   list(range(40, 64)))
EXPLAIN_METHODS = ("grad_x_input", "leave_one_out")


def tp_explain_suite(ctx) -> int:
    """For each ``EXPLAIN_PRESETS`` model (fp32, its whole params in
    ``config["params"]``, a torch save of preset → params): an engine on
    ``{model: world}`` over this rank's shards, its scheduler running on
    rank 0, which serves ``ModelServer.explain_text`` of every
    ``EXPLAIN_PROMPTS`` prompt with each ``EXPLAIN_METHODS`` handler
    (``IdText`` tokens) while the other ranks ``follow``; each rank writes
    its ops by name and rank 0 the explanations."""
    import torch

    from kubeflow_tpu_torch.core.serving import BatchingSpec
    from kubeflow_tpu_torch.models.config import preset
    from kubeflow_tpu_torch.serve.engine import LLMEngine
    from kubeflow_tpu_torch.serve.explain import build_explainer
    from kubeflow_tpu_torch.serve.server import ModelServer

    torch.set_num_threads(1)
    mesh = ctx.mesh
    rank = ctx.env.process_id
    whole = torch.load(ctx.config["params"])
    spec = TP_ENGINE_CASES["contiguous"]
    out = {}
    for name in EXPLAIN_PRESETS:
        cfg = preset(name, dtype="float32")
        eng = LLMEngine(cfg, BatchingSpec(**spec),
                        params=tp_shards(whole[name], cfg, spec, mesh),
                        device="cpu", mesh=mesh)
        rec = {}
        if rank == 0:
            eng.start()
            server = ModelServer(name, eng, tokenizer=IdText())
            for method in EXPLAIN_METHODS:
                server.explainer = build_explainer({"handler": method})
                rec[method] = [server.explain_text(
                    " ".join(map(str, p)), None) for p in EXPLAIN_PROMPTS]
            eng.stop()
        else:
            eng.follow()
        rec["by_op"] = dict(eng._dispatch.by_op)
        out[name] = rec
    torch.save(out, Path(ctx.config["out"]) / f"rank{rank}.pt")
    return 0


# -- pipeline parallelism ------------------------------------------------------

#: name → (mesh axes, port attn_impl, pipeline schedule, preset, overrides)
#: of the pipeline suite (4 ranks, fp32): GPipe beside a data axis (4
#: layers: the Trainer and checkpoint case); 1F1B over four stages (4
#: layers); 1F1B with the stages' blocks split over model; GPipe on
#: tiny-moe with the experts split over expert and binding capacity
#: (factor 0.5: 8 slots an expert of a 32-token microbatch's 64 pairs);
#: GPipe with the flash ring over seq; GPipe on tiny-moe under seq (the
#: balance loss's fractions averaged over the seq ranks).
PP_CASES = {
    "pipe2_data2": ({"pipeline": 2, "data": 2}, "xla", "gpipe", "tiny",
                    {"n_layers": 4}),
    "pipe4": ({"pipeline": 4}, "xla", "1f1b", "tiny", {"n_layers": 4}),
    "pipe2_model2": ({"pipeline": 2, "model": 2}, "xla", "1f1b", "tiny", {}),
    "pipe2_expert2": ({"pipeline": 2, "expert": 2}, "xla", "gpipe",
                      "tiny-moe", {"capacity_factor": 0.5}),
    "pipe2_seq2": ({"pipeline": 2, "seq": 2}, "ring_flash", "gpipe", "tiny",
                   {}),
    "pipe2_seq2_moe": ({"pipeline": 2, "seq": 2}, "ring", "gpipe", "tiny-moe",
                       {}),
}
#: The case a ``Trainer`` runs (5 steps, checkpoints at 2, 4 and 5).
PP_TRAIN_CASE = "pipe2_data2"


def pp_overrides(name: str) -> dict:
    """The model overrides of a ``PP_CASES`` case (fp32 and its
    schedule)."""
    _, _, schedule, _, over = PP_CASES[name]
    return {"dtype": "float32", "pipeline_schedule": schedule, **over}


def pipeline_suite(ctx) -> int:
    """Each ``PP_CASES`` mesh over the gang's 4 ranks: from the seeded
    sharded init, this rank's loss, metrics and synced gradients of
    ``decoder_loss`` on ``tp_tokens`` (its batch rows), and on a
    no-gradient forward each MoE dispatch's router choices and kept
    pairs, and the staged ``decoder_forward``'s logits of its rows (its
    seq part); in ``PP_TRAIN_CASE`` a ``Trainer`` run of 5 steps (losses,
    grad norms, its state after step 2, the checkpoint); with the leaves'
    specs and this rank's coordinates."""
    import torch

    from kubeflow_tpu_torch.models import layers as L
    from kubeflow_tpu_torch.models.config import preset
    from kubeflow_tpu_torch.models.decoder import (
        decoder_forward, decoder_loss,
    )
    from kubeflow_tpu_torch.parallel.fsdp import batch_index
    from kubeflow_tpu_torch.runtime.mesh import build_mesh
    from kubeflow_tpu_torch.train import tree as T
    from kubeflow_tpu_torch.train.optim import OptimizerConfig
    from kubeflow_tpu_torch.train.step import setup_train
    from kubeflow_tpu_torch.train.trainer import Trainer, TrainerConfig

    torch.set_num_threads(1)
    ctx.mesh                                   # join the world
    rank, world = ctx.env.process_id, ctx.env.num_processes
    base = Path(ctx.config["out"])
    plan_of = L.dispatch_plan
    plans: list = []

    def recorded(topk_idx, *args, **kwargs):
        plan = plan_of(topk_idx, *args, **kwargs)
        plans.append((topk_idx.clone(), plan["keep"].clone()))
        return plan

    L.dispatch_plan = recorded
    out = {}
    for name, (axes, attn, _, model, _) in PP_CASES.items():
        mesh = build_mesh(axes, "cpu")
        cfg = preset(model, **pp_overrides(name))
        task = setup_train(cfg, OptimizerConfig(), device="cpu",
                           attn_impl=attn, mesh=mesh)
        params = task.state["params"]
        rec = {"init": T.map_tree(lambda t: t.detach().clone(), params),
               "specs": T.flatten(task.layout.specs),
               "coords": task.layout.coords}
        idx, dp = batch_index(mesh)
        toks = torch.from_numpy(tp_tokens())
        rows = toks[idx * (4 // dp):(idx + 1) * (4 // dp)]
        loss, m = decoder_loss(params, rows, task.cfg, attn_impl=attn,
                               mesh=mesh, placements=task.layout.dims)
        grads = list(torch.autograd.grad(loss, T.leaves(params)))
        task.layout.sync_grads(grads)
        rec.update({k: float(m[k]) for k in ("ce_loss", "aux_loss",
                                              "accuracy")})
        rec["loss"] = float(loss)
        rec["grads"] = T.unflatten(dict(zip(T.flatten(params), grads)))
        rec["grad_norm"] = float(task.layout.global_norm(rec["grads"]))
        plans.clear()
        with torch.no_grad():
            decoder_loss(params, rows, task.cfg, attn_impl=attn, mesh=mesh,
                         placements=task.layout.dims)
        rec["plans"] = list(plans)
        with torch.no_grad():
            rec["logits"] = decoder_forward(params, rows[:, :-1], task.cfg,
                                            attn_impl=attn, mesh=mesh)[0]
        if name == PP_TRAIN_CASE:
            wd = base / name / f"rank{rank}"
            wd.mkdir(parents=True, exist_ok=True)
            conf = train_config(attn, str(base / "ckpt"), model=model,
                                **pp_overrides(name))
            tr = Trainer(TrainerConfig.from_dict(conf), mesh,
                         process_id=rank, num_processes=world, device="cpu",
                         workdir=str(wd))
            rec["losses"], rec["grad_norms"] = [], []

            def on_step(step, m, tr=tr, rec=rec):
                rec["losses"].append(m["loss"])
                rec["grad_norms"].append(m["grad_norm"])
                if step == 2:
                    rec["state2"] = T.map_tree(
                        lambda t: t.detach().clone()
                        if isinstance(t, torch.Tensor) else t,
                        tr.task.state)

            tr.run(on_step=on_step)
        out[name] = rec
    L.dispatch_plan = plan_of
    torch.save(out, base / f"rank{rank}.pt")
    return 0


# -- vision on a mesh ---------------------------------------------------------

#: world → name → (mesh axes, family) of the vision suite: ``tiny-vit``
#: and ``tiny-clip`` in fp32 (tiny-vit's 10 classes do not divide over
#: ``{model: 4}``: its head is whole on every rank; 17 image tokens over
#: ``{seq: 2}`` split unevenly, 9 and 8; the text's 16 evenly), the
#: ``pipeline`` and ``expert`` axes, which no vision leaf names, and JAX's
#: own ViT test mesh as one 8-rank gang.
VISION_CASES = {
    2: {f"{m}-{f}": (axes, f) for m, axes in (
        ("model2", {"model": 2}), ("seq2", {"seq": 2}))
        for f in ("vit", "clip")},
    4: {f"{m}-{f}": (axes, f) for m, axes, fams in (
        ("model4", {"model": 4}, ("vit", "clip")),
        ("data2_model2", {"data": 2, "model": 2}, ("vit", "clip")),
        ("fsdp2_seq2", {"fsdp": 2, "seq": 2}, ("vit", "clip")),
        ("model2_seq2", {"model": 2, "seq": 2}, ("vit", "clip")),
        ("pipeline2_model2", {"pipeline": 2, "model": 2}, ("vit",)),
        ("expert2_seq2", {"expert": 2, "seq": 2}, ("clip",)))
        for f in fams},
    8: {"data2_fsdp2_model2-vit": ({"data": 2, "fsdp": 2, "model": 2},
                                   "vit")},
}
#: The global batch of every vision case, and the steps of its run.
VISION_BATCH = 8
VISION_STEPS = 2
#: SGD, as tests/test_torch_vision.py's one-step check (Adam's first step
#: is sign-like on gradients near fp32 noise).
VISION_OPT = dict(name="sgd", learning_rate=1e-3, warmup_steps=0,
                  total_steps=4)


def vision_cfg(family: str):
    """``tiny-vit`` or ``tiny-clip`` in fp32."""
    from kubeflow_tpu_torch.models import vision as V

    if family == "vit":
        return V.vit_preset("tiny-vit", dtype="float32")
    base = V.clip_preset("tiny-clip")
    return dataclasses.replace(base, image=dataclasses.replace(
        base.image, dtype="float32"), dtype="float32")


def vision_suite(ctx) -> int:
    """Each ``VISION_CASES`` mesh of the gang's world size: this rank's
    loss, metrics and synced gradients of the family's loss on the task's
    init (drawn whole from seed 0 on every rank, then cut) and the global
    batch of step 0 (its rows), then ``VISION_STEPS`` steps of the task
    (metrics, and its params after them), with the leaves' specs and this
    rank's coordinates."""
    import torch

    from kubeflow_tpu_torch.models import vision as V
    from kubeflow_tpu_torch.parallel.collectives import GatheredParams
    from kubeflow_tpu_torch.parallel.fsdp import batch_index
    from kubeflow_tpu_torch.runtime.mesh import build_mesh
    from kubeflow_tpu_torch.train import tree as T
    from kubeflow_tpu_torch.train import vision_task as VT
    from kubeflow_tpu_torch.train.optim import OptimizerConfig

    torch.set_num_threads(1)
    ctx.mesh                                   # join the world
    rank, world = ctx.env.process_id, ctx.env.num_processes
    base = Path(ctx.config["out"])
    out = {}
    for name, (axes, family) in VISION_CASES[world].items():
        mesh = build_mesh(axes, "cpu")
        cfg = vision_cfg(family)
        setup = VT.setup_vit_train if family == "vit" else \
            VT.setup_clip_train
        batch_fn = VT.vit_batch if family == "vit" else VT.clip_batch
        loss_fn = V.vit_loss if family == "vit" else V.clip_loss
        task = setup(cfg, OptimizerConfig(**VISION_OPT), device="cpu",
                     mesh=mesh)
        params = task.state["params"]
        layout = task.layout
        rec = {"specs": T.flatten(layout.specs), "coords": layout.coords}
        idx, dp = batch_index(mesh)
        rows = VISION_BATCH // dp
        batch = {k: torch.from_numpy(v[idx * rows:(idx + 1) * rows])
                 for k, v in batch_fn(cfg, VISION_BATCH, 0).items()}
        loss, m = loss_fn(GatheredParams(params, layout.dims,
                                         layout.fsdp_group), batch, cfg,
                          mesh=mesh)
        grads = list(torch.autograd.grad(loss, T.leaves(params)))
        layout.sync_grads(grads)
        rec["metrics"] = {k: float(v) for k, v in m.items()}
        rec["grads"] = T.unflatten(dict(zip(T.flatten(params), grads)))
        rec["steps"] = []
        for step in range(VISION_STEPS):
            task.state, m = task.step_fn(
                task.state, batch_fn(cfg, VISION_BATCH, step))
            rec["steps"].append({k: float(v) for k, v in m.items()})
        rec["params"] = T.map_tree(lambda t: t.detach().clone(),
                                   task.state["params"])
        out[name] = rec
    torch.save(out, base / f"rank{rank}.pt")
    return 0


# -- dims that do not divide ---------------------------------------------------

#: world → name → (preset, overrides, mesh axes) of the non-divisible
#: suite: tiny on ``{model: 3}`` (4 heads, 2 kv heads, 128 mlp columns and
#: 256 tokens of vocabulary, none of which divides by 3), 6 heads and 3 kv
#: heads on ``{model: 2}`` (the heads split, a rank's three q heads read
#: two kv heads unevenly), and tiny-moe's 4 experts on ``{expert: 3}``.
NONDIV_CASES = {
    3: {"tiny-model3": ("tiny", {}, {"model": 3}),
        "moe-expert3": ("tiny-moe", {}, {"expert": 3})},
    2: {"h6kv3-model2": ("tiny", {"n_heads": 6, "n_kv_heads": 3},
                         {"model": 2})},
}
#: The TP engine layouts each dense case serves.
NONDIV_ENGINES = ("contiguous", "paged")


def nondiv_cfg(name: str, world: int):
    from kubeflow_tpu_torch.models.config import preset

    p, over, _ = NONDIV_CASES[world][name]
    return preset(p, dtype="float32", **over)


def nondiv_suite(ctx) -> int:
    """Each ``NONDIV_CASES`` case of the gang's world size, from the whole
    params in ``config["params"]`` (a torch save: name → tree): this
    rank's ``decoder_loss`` metrics and synced gradients on ``tp_tokens``
    (dispatch and, for MoE, dense), with specs and coordinates; for a
    dense case, a TP engine of each ``NONDIV_ENGINES`` layout on this
    rank's shards: rank 0's greedy completions of ``TP_PROMPTS``."""
    import dataclasses

    import torch

    from kubeflow_tpu_torch.core.serving import BatchingSpec
    from kubeflow_tpu_torch.models.decoder import (
        decoder_layout, decoder_loss, decoder_param_specs,
    )
    from kubeflow_tpu_torch.parallel.fsdp import StateLayout
    from kubeflow_tpu_torch.runtime.mesh import build_mesh
    from kubeflow_tpu_torch.serve.engine import LLMEngine, SamplingParams
    from kubeflow_tpu_torch.train import tree as T

    torch.set_num_threads(1)
    ctx.mesh                                   # join the world
    rank, world = ctx.env.process_id, ctx.env.num_processes
    whole = torch.load(ctx.config["params"])
    out = {}
    for name, (_, _, axes) in NONDIV_CASES[world].items():
        mesh = build_mesh(axes, "cpu")
        cfg = nondiv_cfg(name, world)
        layout = StateLayout(mesh, decoder_param_specs(cfg), whole[name])
        params = T.map_tree(lambda t: t.detach().clone().requires_grad_(
            True), layout.cut(whole[name]))
        rec = {"specs": T.flatten(layout.specs), "coords": layout.coords}
        impls = ("dispatch", "dense") if cfg.is_moe else ("dispatch",)
        for impl in impls:
            c = dataclasses.replace(cfg, moe_impl=impl)
            loss, m = decoder_loss(params, torch.from_numpy(tp_tokens()), c,
                                   mesh=mesh, placements=layout.dims)
            grads = list(torch.autograd.grad(loss, T.leaves(params)))
            layout.sync_grads(grads)
            rec[impl] = {k: float(m[k]) for k in ("ce_loss", "accuracy",
                                                   "aux_loss") if k in m}
            rec[impl]["grads"] = T.unflatten(dict(zip(T.flatten(params),
                                                      grads)))
        if not cfg.is_moe:
            shards = decoder_layout(cfg, mesh).cut(whole[name])
            for eng_name in NONDIV_ENGINES:
                eng = LLMEngine(cfg, BatchingSpec(
                    **TP_ENGINE_CASES[eng_name]), params=shards,
                    device="cpu", mesh=mesh, seed=3)
                if rank == 0:
                    rec[eng_name] = [eng.generate(p, SamplingParams(
                        max_new_tokens=10)) for p in TP_PROMPTS]
                    eng.stop()
                else:
                    eng.follow()
        out[name] = rec
    torch.save(out, Path(ctx.config["out"]) / f"rank{rank}.pt")
    return 0
