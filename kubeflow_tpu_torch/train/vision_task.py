"""Train setup for the vision families, ViT classification and CLIP
contrastive (port of ``kubeflow_tpu/train/vision_task.py``).

The vision counterpart of ``train/step.py``'s decoder task, over the same
optimizer factory and train-state shape ``{"params", "opt_state",
"step"}``. As there, the step runs eagerly and the optimizer updates the
state's tensors in place. The synthetic data sources are the JAX
package's, bit for bit: numpy, seeded by step, with learnable structure
so that "loss decreases" is a real signal.

Under a mesh the state is sharded as the decoder's (``parallel/fsdp.py``):
each rank draws the whole init and keeps its shards (heads, mlp columns,
classes and the text vocabulary over ``model``, the hidden dim over
``fsdp``; a dim that does not divide is whole, as JAX replicates it), takes
its rows of each global batch (over ``dcn``, ``data`` and ``fsdp``: the
``seq``, ``model``, ``expert`` and ``pipeline`` ranks of a batch shard
read the same rows), runs the loss on its part of the work
(``models/vision.VisionAxes``: its positions over ``seq``, its heads and
columns over ``model``), and sums its gradients with the ranks that hold
the same block (over the batch axes and ``seq``; a leaf whole on every
model rank over ``model`` too; ``pipeline``, which no vision leaf names,
like ``seq`` by its ranks' 1/copies parts of the loss).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from kubeflow_tpu_torch.device import resolve_device
from kubeflow_tpu_torch.models.vision import (
    CLIPConfig, ViTConfig, clip_loss, clip_param_specs, init_clip_params,
    init_vit_params, vit_loss, vit_param_specs,
)
from kubeflow_tpu_torch.parallel.collectives import GatheredParams
from kubeflow_tpu_torch.parallel.fsdp import StateLayout, batch_index
from kubeflow_tpu_torch.train import tree as T
from kubeflow_tpu_torch.train.optim import (
    OptimizerConfig, apply_optimizer, make_optimizer,
)
from kubeflow_tpu_torch.train.step import trainable


@dataclasses.dataclass
class VisionTask:
    cfg: Any
    device: torch.device
    optimizer: Any
    state: Any                      # {"params", "opt_state", "step"}
    step_fn: Callable[[Any, dict], tuple[Any, dict]]
    mesh: Any = None
    layout: Any = None


def _setup(cfg, init_fn, specs_fn, loss_fn, opt_cfg: OptimizerConfig,
           device, seed: int, mesh=None) -> VisionTask:
    dev = resolve_device(device)
    optimizer = make_optimizer(opt_cfg)
    params = init_fn(torch.Generator(dev).manual_seed(seed), cfg)
    layout = None
    if mesh is not None:
        layout = StateLayout(mesh, specs_fn(cfg), params)
        params = layout.cut(params)
    shard, dp = batch_index(mesh)
    state = trainable({"params": params, "opt_state": optimizer.init(params),
                       "step": 0})

    def step_fn(state: dict, batch: dict):
        params = state["params"]
        on_dev = {}
        for k, v in batch.items():
            t = torch.as_tensor(v)
            if dp > 1:
                if t.shape[0] % dp:
                    raise ValueError(f"batch of {t.shape[0]} does not "
                                     f"divide over {dp} batch shards")
                rows = t.shape[0] // dp
                t = t[shard * rows:(shard + 1) * rows]
            on_dev[k] = t.to(dev)
        view = params if layout is None else GatheredParams(
            params, layout.dims, layout.fsdp_group)
        loss, metrics = loss_fn(view, on_dev, cfg, mesh=mesh)
        grads = torch.autograd.grad(loss, T.leaves(params))
        gnorm = None
        if layout is not None:
            layout.sync_grads(grads)
        grad_tree = T.unflatten(dict(zip(T.flatten(params), grads)))
        if layout is not None:
            gnorm = layout.global_norm(grad_tree)
        _, opt_state, grad_norm = apply_optimizer(
            optimizer, grad_tree, state["opt_state"], params, gnorm)
        metrics = dict(metrics)
        metrics["grad_norm"] = grad_norm
        state["opt_state"] = opt_state
        state["step"] = int(state["step"]) + 1
        return state, metrics

    return VisionTask(cfg=cfg, device=dev, optimizer=optimizer, state=state,
                      step_fn=step_fn, mesh=mesh, layout=layout)


def setup_vit_train(cfg: ViTConfig, opt_cfg: OptimizerConfig, *,
                    device: str | torch.device = "cuda",
                    seed: int = 0, mesh=None) -> VisionTask:
    """The ViT task on ``device`` (default the card; raises without one
    unless ``device="cpu"``), sharded over ``mesh`` when one is given."""
    return _setup(cfg, init_vit_params, vit_param_specs, vit_loss, opt_cfg,
                  device, seed, mesh)


def setup_clip_train(cfg: CLIPConfig, opt_cfg: OptimizerConfig, *,
                     device: str | torch.device = "cuda",
                     seed: int = 0, mesh=None) -> VisionTask:
    """The CLIP task on ``device`` (default the card)."""
    return _setup(cfg, init_clip_params, clip_param_specs, clip_loss,
                  opt_cfg, device, seed, mesh)


# -- synthetic data --------------------------------------------------------------

def vit_batch(cfg: ViTConfig, batch: int, step: int) -> dict:
    """Class-conditional gaussians: label k tints channel k%C in quadrant
    k%4 — linearly separable enough that a learning ViT's loss drops."""
    rng = np.random.default_rng(step)
    labels = rng.integers(0, max(cfg.num_classes, 2), size=batch)
    imgs = rng.normal(0, 0.3, size=(batch, cfg.image_size, cfg.image_size,
                                    cfg.channels)).astype(np.float32)
    half = cfg.image_size // 2
    for i, y in enumerate(labels):
        qh, qw = (y % 4) // 2, (y % 4) % 2
        imgs[i, qh * half:(qh + 1) * half, qw * half:(qw + 1) * half,
             y % cfg.channels] += 1.5
    return {"images": imgs, "labels": labels.astype(np.int32)}


def clip_batch(cfg: CLIPConfig, batch: int, step: int) -> dict:
    """Paired modality toy: token sequence k co-occurs with image tint k."""
    rng = np.random.default_rng(step)
    concept = rng.integers(0, 16, size=batch)
    icfg = cfg.image
    imgs = rng.normal(0, 0.3, size=(batch, icfg.image_size, icfg.image_size,
                                    icfg.channels)).astype(np.float32)
    for i, k in enumerate(concept):
        imgs[i, :, :, k % icfg.channels] += 0.5 + 0.1 * k
    toks = np.zeros((batch, cfg.text_len), dtype=np.int32)
    toks[:, 0] = 1 + concept          # "word" for the concept
    toks[:, 1] = cfg.text_vocab - 1   # EOT (highest id → argmax pooling)
    return {"images": imgs, "tokens": toks}
