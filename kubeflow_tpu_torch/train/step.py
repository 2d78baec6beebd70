"""Train step construction on one device (port of
``kubeflow_tpu/train/step.py``).

``setup_train`` builds what a worker needs from (model cfg, optimizer cfg,
device): the initial state ``{"params", "opt_state", "step"}`` and
``step_fn(state, batch) -> (state, metrics)``. The JAX package jits a
donated, sharded step; here the step runs eagerly and the optimizer
updates the state's tensors in place, so ``step_fn`` returns the state it
was given, advanced. Metrics are 0-dim tensors on the device: reading one
waits for the step, so the loop reads them only where it logs.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from kubeflow_tpu_torch.device import resolve_device
from kubeflow_tpu_torch.models.config import DecoderConfig
from kubeflow_tpu_torch.models.decoder import decoder_loss, init_decoder_params
from kubeflow_tpu_torch.train import tree as T
from kubeflow_tpu_torch.train.optim import (
    OptimizerConfig, apply_optimizer, make_optimizer,
)


@dataclasses.dataclass
class TrainTask:
    """Everything a worker needs to run steps."""

    cfg: DecoderConfig
    device: torch.device
    optimizer: Any
    state: Any                      # {"params", "opt_state", "step"}
    step_fn: Callable[[Any, torch.Tensor], tuple[Any, dict]]
    # K steps per call over stacked [K, B, S+1] batches, returning the last
    # step's metrics.
    multi_step_fn: Callable[[Any, torch.Tensor], tuple[Any, dict]]

    @property
    def params(self):
        return self.state["params"]


def trainable(state: dict) -> dict:
    """``state`` with every parameter marked as requiring a gradient (a
    restored or converted state comes without the mark)."""
    for p in T.leaves(state["params"]):
        p.requires_grad_(True)
    return state


def make_state_init(cfg: DecoderConfig, optimizer, device, seed: int = 0):
    """The single source of truth for the train-state structure: random
    params from a ``torch.Generator`` seeded with ``seed`` on ``device``,
    the optimizer's zero state, step 0."""
    dev = resolve_device(device)

    def init_fn() -> dict:
        gen = torch.Generator(dev).manual_seed(seed)
        params = init_decoder_params(gen, cfg)
        return trainable({"params": params,
                          "opt_state": optimizer.init(params), "step": 0})

    return init_fn


def setup_train(
    cfg: DecoderConfig,
    opt_cfg: OptimizerConfig,
    *,
    device: str | torch.device = "cuda",
    seed: int = 0,
    attn_impl: str = "xla",
    init_state: bool = True,
) -> TrainTask:
    """The train task on ``device`` (default the card; raises without one
    unless ``device="cpu"``)."""
    dev = resolve_device(device)
    optimizer = make_optimizer(opt_cfg)
    state = make_state_init(cfg, optimizer, dev, seed)() if init_state \
        else None

    def step_fn(state: dict, batch: torch.Tensor):
        params = state["params"]
        loss, metrics = decoder_loss(params, batch.to(dev), cfg,
                                     attn_impl=attn_impl)
        leaves = T.leaves(params)
        grads = torch.autograd.grad(loss, leaves)
        flat = T.flatten(params)
        grad_tree = T.unflatten(dict(zip(flat, grads)))
        _, opt_state, grad_norm = apply_optimizer(
            optimizer, grad_tree, state["opt_state"], params)
        metrics = dict(metrics)
        metrics["loss"] = loss.detach()
        metrics["grad_norm"] = grad_norm
        state["opt_state"] = opt_state
        state["step"] = int(state["step"]) + 1
        return state, metrics

    def multi_step_fn(state: dict, batches: torch.Tensor):
        metrics: dict = {}
        for batch in batches:
            state, metrics = step_fn(state, batch)
        return state, metrics

    return TrainTask(cfg=cfg, device=dev, optimizer=optimizer, state=state,
                     step_fn=step_fn, multi_step_fn=multi_step_fn)
