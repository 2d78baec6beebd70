"""Registered trainer entrypoints — what a job's worker names (port of
``kubeflow_tpu/train/entrypoints.py``).

``llm_pretrain`` runs the ``Trainer`` over ``TrainerConfig`` fields taken
from the worker config verbatim; ``vision_train`` runs the ViT or CLIP
task (its metrics add each logging window's wall ms per step). Both run
on the worker's device (``WorkerContext.device``: the card, or the CPU
when ``KFTPU_PLATFORM=cpu``), over the mesh of a multi-process or
sharded worker (``WorkerContext.mesh``, from ``bootstrap_worker``). Their
imports happen inside the functions, so resolving a trivial entrypoint
imports no torch.
"""

from __future__ import annotations

import os
import time

from kubeflow_tpu_torch.runtime.entrypoints import (
    WorkerContext, register_entrypoint,
)


def _metrics_path(ctx: WorkerContext):
    if ctx.env.workdir and ctx.is_coordinator:
        return os.path.join(ctx.env.workdir, "metrics.jsonl")
    return None


@register_entrypoint("vision_train")
def vision_train(ctx: WorkerContext) -> int:
    """ViT classification / CLIP contrastive training. Config:
    {"family": "vit"|"clip", "model": preset, "steps", "batch",
    "optimizer": {...}, "model_overrides": {...}, "log_every"}. A CLIP
    config's ``model_overrides`` may hold ``"image": {...}``, fields of
    its image tower (the ``dtype`` of the CLIP config itself reaches the
    text tower alone, as in JAX)."""
    import dataclasses

    from kubeflow_tpu_torch.models.vision import clip_preset, vit_preset
    from kubeflow_tpu_torch.train.metrics import MetricsEmitter
    from kubeflow_tpu_torch.train.optim import OptimizerConfig
    from kubeflow_tpu_torch.train.vision_task import (
        clip_batch, setup_clip_train, setup_vit_train, vit_batch,
    )

    mesh = ctx.mesh
    cfg = ctx.config
    family = cfg.get("family", "vit")
    steps = int(cfg.get("steps", 20))
    batch = int(cfg.get("batch", 8))
    opt = OptimizerConfig.from_dict(
        {"total_steps": steps, "warmup_steps": 0, **cfg.get("optimizer", {})})
    overrides = dict(cfg.get("model_overrides", {}))
    if family == "vit":
        mcfg = vit_preset(cfg.get("model", "tiny-vit"), **overrides)
        task = setup_vit_train(mcfg, opt, device=ctx.device, mesh=mesh)
        batch_fn = lambda step: vit_batch(mcfg, batch, step)  # noqa: E731
    elif family == "clip":
        image = overrides.pop("image", None)
        mcfg = clip_preset(cfg.get("model", "tiny-clip"), **overrides)
        if image:
            mcfg = dataclasses.replace(
                mcfg, image=dataclasses.replace(mcfg.image, **image))
        task = setup_clip_train(mcfg, opt, device=ctx.device, mesh=mesh)
        batch_fn = lambda step: clip_batch(mcfg, batch, step)  # noqa: E731
    else:
        raise ValueError(f"unknown vision family {family!r}")

    emitter = MetricsEmitter(jsonl_path=_metrics_path(ctx))
    log_every = int(cfg.get("log_every", 1))
    state = task.state
    t_last, last = time.perf_counter(), 0
    try:
        for step in range(steps):
            state, metrics = task.step_fn(state, batch_fn(step))
            # Read the device only on logging steps (the read waits for
            # the step, so the window's wall time per step follows it).
            if (step + 1) % log_every == 0 or step + 1 == steps:
                out = {k: float(v) for k, v in metrics.items()}
                now = time.perf_counter()
                out["step_time_ms"] = (now - t_last) * 1e3 / (step + 1 - last)
                t_last, last = now, step + 1
                emitter.emit(step, out)
    finally:
        emitter.close()
    return 0


@register_entrypoint("llm_pretrain")
def llm_pretrain(ctx: WorkerContext) -> int:
    """Decoder pretraining through ``Trainer.run()``: checkpoints,
    resume, preemption and ``metrics.jsonl`` in the worker's workdir."""
    from kubeflow_tpu_torch.train.trainer import Trainer, TrainerConfig

    mesh = ctx.mesh
    cfg = TrainerConfig.from_dict(ctx.config)
    trainer = Trainer(cfg, mesh, process_id=ctx.env.process_id,
                      num_processes=ctx.env.num_processes, device=ctx.device,
                      metrics_path=_metrics_path(ctx),
                      workdir=ctx.env.workdir)
    trainer.run()
    return 0
