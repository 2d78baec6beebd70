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


class IdText:
    """A tokenizer that writes token ids as decimal text (``module:factory``
    ``dist_support:IdText``), so a server's completions read back as the
    engine's ids."""

    eos_id = None

    def encode(self, text: str) -> list[int]:
        return [int(x) for x in text.split()]

    def decode(self, ids: list[int]) -> str:
        return "".join(f" {i}" for i in ids)
