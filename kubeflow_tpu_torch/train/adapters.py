"""Second-framework training adapters (port of
``kubeflow_tpu/train/adapters.py``).

A framework adapter is a registered entrypoint: it reads the same
``WorkerEnv`` a worker of any job gets (coordinator address, world size,
rank) and reports through the same ``metrics.jsonl`` convention, so the
job's gangs, restarts and exit-code policy apply unchanged.

``torch_train``: data-parallel PyTorch regression on synthetic data, on
the worker's device, with the JAX adapter's gloo design: a world of more
than one process rendezvouses through a file store in the shared job
directory and all-reduces its gradients. Gloo all-reduces CUDA tensors
too, so several ranks may share one card. It never asks for the
worker's mesh, so the worker joins no other process group.
"""

from __future__ import annotations

import os

from kubeflow_tpu_torch.runtime.entrypoints import (
    WorkerContext, register_entrypoint,
)


@register_entrypoint("torch_train")
def torch_train(ctx: WorkerContext) -> int:
    """Distributed PyTorch regression on synthetic data.

    Config: {"steps": int, "batch": int, "hidden": int, "in_dim": int,
    "lr": float, "log_every": int}. The model and the fixed teacher are
    drawn on the CPU from seed 0 (the same on every rank) and the data
    from a per-rank generator, then moved to the device. A multi-worker
    job rendezvouses with gloo through a file store keyed by the
    coordinator's port in the shared job directory (the parent of the
    worker's workdir) and all-reduces its gradients, divided by the world
    size; the coordinator writes metrics.jsonl and a final checkpoint.pt
    (CPU tensors)."""
    import torch
    import torch.distributed as dist

    from kubeflow_tpu_torch.train.metrics import MetricsEmitter

    cfg = ctx.config
    steps = int(cfg.get("steps", 20))
    batch = int(cfg.get("batch", 32))
    hidden = int(cfg.get("hidden", 32))
    in_dim = int(cfg.get("in_dim", 8))
    lr = float(cfg.get("lr", 1e-2))
    log_every = int(cfg.get("log_every", 1))
    world = ctx.env.num_processes
    rank = ctx.env.process_id
    dev = torch.device(ctx.device)

    store_file = None
    if world > 1:
        # The store file is keyed by the coordinator port, allocated fresh
        # per gang attempt, so a restart never joins a stale store; it
        # lives in the job directory every worker's workdir sits in.
        port = ctx.env.coordinator_address.rsplit(":", 1)[1]
        shared = os.path.dirname(ctx.env.workdir.rstrip(os.sep))
        store_file = os.path.join(shared, f"gloo_{port}")
        dist.init_process_group(
            "gloo", init_method=f"file://{store_file}",
            world_size=world, rank=rank)

    torch.manual_seed(0)
    model = torch.nn.Sequential(
        torch.nn.Linear(in_dim, hidden), torch.nn.Tanh(),
        torch.nn.Linear(hidden, 1))
    # Fixed teacher so the loss floor is 0 and descent is observable.
    teacher = torch.nn.Linear(in_dim, 1)
    for p in teacher.parameters():
        p.requires_grad_(False)
    model.to(dev)
    teacher.to(dev)
    opt = torch.optim.Adam(model.parameters(), lr=lr)

    emitter = MetricsEmitter(
        jsonl_path=(os.path.join(ctx.env.workdir, "metrics.jsonl")
                    if ctx.env.workdir and ctx.is_coordinator else None))
    gen = torch.Generator().manual_seed(1234 + rank)   # per-rank data shard
    try:
        for step in range(steps):
            x = torch.randn(batch, in_dim, generator=gen).to(dev)
            y = teacher(x).detach()
            loss = torch.nn.functional.mse_loss(model(x), y)
            opt.zero_grad()
            loss.backward()
            if world > 1:
                for p in model.parameters():
                    dist.all_reduce(p.grad)
                    p.grad /= world
            opt.step()
            if ctx.is_coordinator and ((step + 1) % log_every == 0
                                       or step + 1 == steps):
                emitter.emit(step, {"loss": float(loss.detach())})
        if ctx.env.workdir and (ctx.is_coordinator or world > 1):
            # Every rank of a gang keeps its final weights (they must be
            # equal: one checks the all-reduce); the coordinator's is the
            # job's checkpoint.
            name = ("checkpoint.pt" if ctx.is_coordinator
                    else f"checkpoint.rank{rank}.pt")
            torch.save({k: v.cpu() for k, v in model.state_dict().items()},
                       os.path.join(ctx.env.workdir, name))
        if world > 1:
            # Success path only: every peer has left the rendezvous before
            # the coordinator retires the store file (a recycled port must
            # never find a stale store).
            dist.barrier()
            if ctx.is_coordinator:
                try:
                    os.unlink(store_file)
                except OSError:
                    pass
    finally:
        emitter.close()
        if world > 1:
            dist.destroy_process_group()
    return 0
