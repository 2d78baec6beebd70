"""Train step construction (port of ``kubeflow_tpu/train/step.py``).

``setup_train`` builds what a worker needs from (model cfg, optimizer cfg,
device, and a mesh when the job is spread over processes): the initial
state ``{"params", "opt_state", "step"}`` and ``step_fn(state, batch) ->
(state, metrics)``. The JAX package jits a donated, sharded step; here the
step runs eagerly and the optimizer updates the state's tensors in place,
so ``step_fn`` returns the state it was given, advanced. Metrics are 0-dim
tensors on the device: reading one waits for the step, so the loop reads
them only where it logs.

Under a mesh (``parallel/fsdp.py``) the state's layout comes from the
params' shapes alone (``abstract_decoder_params``); every rank then draws
the init from the seed leaf by leaf, cutting each leaf to its local shard
(``embed`` over ``fsdp``) as soon as it is drawn, so it holds exactly the
values of a one-process run with at most one whole leaf alive; the step
reads the shards through
all-gathers per layer, sums the gradients over the ranks that hold the
same block, and updates the local shards with the global gradient norm.
A ``pipeline`` degree stages the layers (the rule ``layers → pipeline``:
a stage draws every layer and keeps its own block of them), and the loss
runs the schedule (``models/decoder.staged_loss``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from kubeflow_tpu_torch.device import resolve_device
from kubeflow_tpu_torch.models.config import DecoderConfig
from kubeflow_tpu_torch.models.decoder import (
    AUX_LOSS_WEIGHT, abstract_decoder_params, check_stages, decoder_loss,
    decoder_param_specs, init_decoder_params,
)
from kubeflow_tpu_torch.parallel.fsdp import StateLayout, pipelined
from kubeflow_tpu_torch.parallel.sharding import (
    DEFAULT_RULES, LogicalRules, mesh_shape, with_rule,
)
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
    mesh: Any = None
    # Placements and groups of a sharded state (None without a mesh).
    layout: Optional[StateLayout] = None

    @property
    def params(self):
        return self.state["params"]


def trainable(state: dict) -> dict:
    """``state`` with every parameter marked as requiring a gradient (a
    restored or converted state comes without the mark)."""
    for p in T.leaves(state["params"]):
        p.requires_grad_(True)
    return state


def make_state_init(cfg: DecoderConfig, optimizer, device, seed: int = 0,
                    layout: Optional[StateLayout] = None):
    """The single source of truth for the train-state structure: random
    params from a ``torch.Generator`` seeded with ``seed`` on ``device``,
    the optimizer's zero state, step 0. With ``layout`` (a sharded state)
    each leaf is cut to this rank's shard as it is drawn."""
    dev = resolve_device(device)

    def init_fn():
        gen = torch.Generator(dev).manual_seed(seed)
        params = init_decoder_params(
            gen, cfg, shard=None if layout is None else layout.cut_leaf,
            layers=None if layout is None
            else layout.stage_layers(cfg.n_layers))
        return trainable({"params": params,
                          "opt_state": optimizer.init(params), "step": 0})

    return init_fn


def _state_shardings(cfg: DecoderConfig, mesh,
                     rules: LogicalRules) -> StateLayout:
    """The layout of the train state on ``mesh`` (JAX's
    ``_state_shardings``), from the params' shapes alone: their
    placements, which the optimizer moments mirror; counts and the step
    are plain values."""
    return StateLayout(mesh, decoder_param_specs(cfg),
                       abstract_decoder_params(cfg), rules)


def setup_train(
    cfg: DecoderConfig,
    opt_cfg: OptimizerConfig,
    *,
    device: str | torch.device = "cuda",
    seed: int = 0,
    attn_impl: str = "xla",
    init_state: bool = True,
    mesh=None,
    rules: LogicalRules = DEFAULT_RULES,
) -> TrainTask:
    """The train task on ``device`` (default the card; raises without one
    unless ``device="cpu"``), sharded over ``mesh`` when one is given."""
    dev = resolve_device(device)
    optimizer = make_optimizer(opt_cfg)
    if pipelined(mesh):
        # Stage the layer stack: its stacked dim over the pipeline axis.
        check_stages(cfg, mesh_shape(mesh))
        rules = with_rule(rules, "layers", "pipeline")
    layout = None if mesh is None else _state_shardings(cfg, mesh, rules)
    init_fn = make_state_init(cfg, optimizer, dev, seed, layout)
    state = init_fn() if init_state else None
    placements = layout.dims if layout is not None else None

    def step_fn(state: dict, batch: torch.Tensor):
        params = state["params"]
        loss, metrics = decoder_loss(params, batch.to(dev), cfg,
                                     attn_impl=attn_impl, mesh=mesh,
                                     placements=placements)
        leaves = T.leaves(params)
        grads = torch.autograd.grad(loss, leaves)
        gnorm = None
        if layout is not None:
            layout.sync_grads(grads)
        flat = T.flatten(params)
        grad_tree = T.unflatten(dict(zip(flat, grads)))
        if layout is not None:
            gnorm = layout.global_norm(grad_tree)
        _, opt_state, grad_norm = apply_optimizer(
            optimizer, grad_tree, state["opt_state"], params, gnorm)
        metrics = dict(metrics)
        # Under a mesh ``loss`` is this rank's part (the staged loss's
        # value is already global); the metric is the global value (the
        # balance loss 0 for a dense config).
        metrics["loss"] = (loss.detach() if mesh is None
                           else metrics["ce_loss"]
                           + AUX_LOSS_WEIGHT * metrics["aux_loss"])
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
                     step_fn=step_fn, multi_step_fn=multi_step_fn, mesh=mesh,
                     layout=layout)
