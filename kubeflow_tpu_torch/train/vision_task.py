"""Train setup for the vision families, ViT classification and CLIP
contrastive, on one device (port of ``kubeflow_tpu/train/vision_task.py``).

The vision counterpart of ``train/step.py``'s decoder task, over the same
optimizer factory and train-state shape ``{"params", "opt_state",
"step"}``. As there, the step runs eagerly and the optimizer updates the
state's tensors in place. The synthetic data sources are the JAX
package's, bit for bit: numpy, seeded by step, with learnable structure
so that "loss decreases" is a real signal.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from kubeflow_tpu_torch.device import resolve_device
from kubeflow_tpu_torch.models.vision import (
    CLIPConfig, ViTConfig, clip_loss, init_clip_params, init_vit_params,
    vit_loss,
)
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


def _setup(cfg, init_fn, loss_fn, opt_cfg: OptimizerConfig, device,
           seed: int) -> VisionTask:
    dev = resolve_device(device)
    optimizer = make_optimizer(opt_cfg)
    params = init_fn(torch.Generator(dev).manual_seed(seed), cfg)
    state = trainable({"params": params, "opt_state": optimizer.init(params),
                       "step": 0})

    def step_fn(state: dict, batch: dict):
        params = state["params"]
        on_dev = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
        loss, metrics = loss_fn(params, on_dev, cfg)
        grads = torch.autograd.grad(loss, T.leaves(params))
        grad_tree = T.unflatten(dict(zip(T.flatten(params), grads)))
        _, opt_state, grad_norm = apply_optimizer(
            optimizer, grad_tree, state["opt_state"], params)
        metrics = dict(metrics)
        metrics["grad_norm"] = grad_norm
        state["opt_state"] = opt_state
        state["step"] = int(state["step"]) + 1
        return state, metrics

    return VisionTask(cfg=cfg, device=dev, optimizer=optimizer, state=state,
                      step_fn=step_fn)


def setup_vit_train(cfg: ViTConfig, opt_cfg: OptimizerConfig, *,
                    device: str | torch.device = "cuda",
                    seed: int = 0) -> VisionTask:
    """The ViT task on ``device`` (default the card; raises without one
    unless ``device="cpu"``)."""
    return _setup(cfg, init_vit_params, vit_loss, opt_cfg, device, seed)


def setup_clip_train(cfg: CLIPConfig, opt_cfg: OptimizerConfig, *,
                     device: str | torch.device = "cuda",
                     seed: int = 0) -> VisionTask:
    """The CLIP task on ``device`` (default the card)."""
    return _setup(cfg, init_clip_params, clip_loss, opt_cfg, device, seed)


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
