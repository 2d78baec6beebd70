"""Second-framework training adapters (port of
``kubeflow_tpu/train/adapters.py``).

A framework adapter is a registered entrypoint: it reads the same
``WorkerEnv`` a worker of any job gets (coordinator address, world size,
rank) and reports through the same ``metrics.jsonl`` convention, so the
job's gangs, restarts and exit-code policy apply unchanged.

``torch_train``: a plain PyTorch regression on synthetic data, on the
worker's device. The port runs one process on one device: a world of more
than one process is refused (``runtime.bootstrap.bootstrap_worker``); the
gloo rendezvous and gradient all-reduce arrive with multi-GPU workers.
"""

from __future__ import annotations

import os

from kubeflow_tpu_torch.runtime.entrypoints import (
    WorkerContext, register_entrypoint,
)


@register_entrypoint("torch_train")
def torch_train(ctx: WorkerContext) -> int:
    """PyTorch regression on synthetic data.

    Config: {"steps": int, "batch": int, "hidden": int, "in_dim": int,
    "lr": float, "log_every": int}. The model and the fixed teacher are
    drawn on the CPU from seed 0 and the data from a per-rank generator,
    then moved to the device, so every device trains on the same numbers;
    the coordinator writes metrics.jsonl and a final checkpoint.pt (CPU
    tensors)."""
    import torch

    from kubeflow_tpu_torch.runtime.bootstrap import bootstrap_worker
    from kubeflow_tpu_torch.train.metrics import MetricsEmitter

    bootstrap_worker(ctx.env)
    cfg = ctx.config
    steps = int(cfg.get("steps", 20))
    batch = int(cfg.get("batch", 32))
    hidden = int(cfg.get("hidden", 32))
    in_dim = int(cfg.get("in_dim", 8))
    lr = float(cfg.get("lr", 1e-2))
    log_every = int(cfg.get("log_every", 1))
    rank = ctx.env.process_id
    dev = torch.device(ctx.device)

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
            opt.step()
            if ctx.is_coordinator and ((step + 1) % log_every == 0
                                       or step + 1 == steps):
                emitter.emit(step, {"loss": float(loss.detach())})
        if ctx.is_coordinator and ctx.env.workdir:
            torch.save({k: v.cpu() for k, v in model.state_dict().items()},
                       os.path.join(ctx.env.workdir, "checkpoint.pt"))
    finally:
        emitter.close()
    return 0
