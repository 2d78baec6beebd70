"""Optimizers: AdamW/Adam/SGD with global-norm clipping and a warmup-cosine
schedule (port of ``kubeflow_tpu/train/optim.py``).

The JAX package builds an optax chain (``clip_by_global_norm`` first, then
``adamw``/``adam``/``sgd``) or, with ``fused=True``, ``FusedAdamW``. This
module computes the same updates as plain tensor ops, in the same order:

- the chain: clip (``g`` kept when the global norm is under the limit, else
  ``g / norm * limit``), Adam moments ``(1 - b1)·g + b1·mu`` and
  ``(1 - b2)·g² + b2·nu``, bias correction ``1 - b^count`` in fp32 after the
  count's increment, ``mu_hat / (sqrt(nu_hat) + eps)`` (eps outside the
  sqrt), weight decay ``+ wd·p`` on every leaf (optax's default mask), then
  ``-lr(count)`` with the schedule read at the count before its increment,
  and ``p + u`` cast back to the parameter's dtype. ``mu_dtype`` stores mu
  in that dtype; nu stays fp32. SGD is optax's ``trace`` with momentum 0.9.
- ``FusedAdamW``: the clip scale folded into one elementwise pass per leaf,
  fp32 ``nu`` whatever the parameter dtype.

``torch.optim`` is not used: its AdamW puts eps elsewhere, scales weight
decay by the learning rate before the step and keeps no schedule count.
Unlike the JAX functions, ``apply`` updates parameters and moments in
place (under ``torch.no_grad``): a full-width model cannot afford a second
copy of its optimizer state. The optimizer state is a dict:
``{"count": int, "mu": tree, "nu": tree}`` for the Adam kinds and
``{"count": int, "trace": tree}`` for SGD (``models/convert.py::
opt_state_from_jax`` carries an optax state across).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional

import numpy as np
import torch

from kubeflow_tpu_torch.models.config import torch_dtype
from kubeflow_tpu_torch.train import tree as T


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adamw"
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0
    # First-moment dtype ("bfloat16" halves mu's memory; nu stays fp32).
    mu_dtype: Optional[str] = None
    # One-pass update with the clip scale inline (adamw only).
    fused: bool = False

    @classmethod
    def from_dict(cls, d: dict) -> "OptimizerConfig":
        return cls(**{k: v for k, v in d.items()
                      if k in {f.name for f in dataclasses.fields(cls)}})


def make_schedule(cfg: OptimizerConfig) -> Callable[[int], float]:
    """Linear warmup from 0 over ``max(warmup, 1)`` steps joined at
    ``warmup_steps`` to a cosine decay to ``min_lr_ratio`` — optax's
    ``join_schedules([linear_schedule, cosine_decay_schedule])``, evaluated
    in fp32 as optax evaluates it."""
    f32 = np.float32
    lr, alpha = float(cfg.learning_rate), float(cfg.min_lr_ratio)
    warm = max(cfg.warmup_steps, 1)
    decay = max(cfg.total_steps - cfg.warmup_steps, 1)

    def linear(c: int) -> f32:
        c = min(max(c, 0), warm)
        frac = f32(1) - f32(c) / f32(warm)
        return f32(0.0 - lr) * frac + f32(lr)

    def cosine(c: int) -> f32:
        c = f32(min(c, decay))
        cd = f32(0.5) * (f32(1) + np.cos(f32(math.pi) * c / f32(decay)))
        return f32(lr) * (f32(1 - alpha) * cd + f32(alpha))

    def schedule(count: int) -> float:
        count = int(count)
        if count < cfg.warmup_steps:
            return float(linear(count))
        return float(cosine(count - cfg.warmup_steps))

    return schedule


def global_norm(grads: Any, groups: Any = None) -> torch.Tensor:
    """sqrt of the sum over leaves (sorted-key order) of each leaf's sum of
    squares, in fp32, on the leaves' device.

    Sharded gradients (``groups``, a tree mirroring ``grads``: the group
    of the ranks a leaf's blocks are split over, or None for a whole
    leaf): the squares of the local blocks are summed and all-reduced over
    their group, once per group, and a whole leaf is counted once, not
    once a rank."""
    if groups is None:
        total = None
        for g in T.leaves(grads):
            s = torch.sum(g.float() * g.float())
            total = s if total is None else total + s
        return torch.sqrt(total)
    import torch.distributed as dist

    parts: dict = {}
    for g, grp in zip(T.leaves(grads), T.leaves(groups)):
        parts.setdefault(grp, []).append(torch.sum(g.float() * g.float()))
    total = None
    for grp, sq in parts.items():
        part = torch.stack(sq).sum()
        if grp is not None:
            dist.all_reduce(part, group=grp)
        total = part if total is None else total + part
    return torch.sqrt(total)


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


class ChainOptimizer:
    """The optax chain ``clip_by_global_norm`` → ``adamw``/``adam``/``sgd``
    → ``apply_updates``, as one in-place update per leaf."""

    def __init__(self, cfg: OptimizerConfig, schedule: Callable[[int], float]):
        if cfg.name not in ("adamw", "adam", "sgd"):
            raise ValueError(f"unknown optimizer {cfg.name!r}")
        self.cfg = cfg
        self.schedule = schedule

    def init(self, params: Any) -> dict:
        if self.cfg.name == "sgd":
            return {"count": 0, "trace": T.map_tree(
                lambda p: torch.zeros_like(p, dtype=torch.float32,
                                           requires_grad=False), params)}
        mu_dt = torch_dtype(self.cfg.mu_dtype) if self.cfg.mu_dtype else None
        return {
            "count": 0,
            "mu": T.map_tree(lambda p: torch.zeros_like(
                p, dtype=mu_dt or p.dtype, requires_grad=False), params),
            "nu": T.map_tree(lambda p: torch.zeros_like(
                p, requires_grad=False), params),
        }

    @torch.no_grad()
    def apply(self, grads: Any, opt_state: dict, params: Any,
              gnorm: Optional[torch.Tensor] = None):
        c = self.cfg
        count = int(opt_state["count"])
        gnorm = global_norm(grads) if gnorm is None else gnorm
        trigger = gnorm < c.clip_norm if c.clip_norm is not None else None
        lr = self.schedule(count)
        ps, gs = T.leaves(params), T.leaves(grads)
        if c.name == "sgd":
            for p, g, t in zip(ps, gs, T.leaves(opt_state["trace"])):
                g = self._clip(g, gnorm, trigger)
                t.copy_(g + 0.9 * t)
                p.copy_((p + _f32(-lr, t) * t).to(p.dtype))
        else:
            n = count + 1
            bc1 = 1 - _f32(c.b1, gnorm) ** n
            bc2 = 1 - _f32(c.b2, gnorm) ** n
            for p, g, m, v in zip(ps, gs, T.leaves(opt_state["mu"]),
                                  T.leaves(opt_state["nu"])):
                g = self._clip(g, gnorm, trigger)
                # b1 in mu's dtype first, as a JAX weak-typed scalar is.
                b1 = torch.tensor(c.b1, dtype=m.dtype, device=m.device)
                m32 = (1 - c.b1) * g + b1 * m
                v.copy_((1 - c.b2) * (g * g) + c.b2 * v)
                u = (m32 / bc1.to(m32.dtype)) / (
                    torch.sqrt(v / bc2.to(v.dtype) + 0.0) + c.eps)
                m.copy_(m32.to(m.dtype))
                if c.name == "adamw":
                    u = u + c.weight_decay * p
                u = _f32(-lr, u) * u
                p.copy_((p + u).to(p.dtype))
        return params, {**opt_state, "count": count + 1}, gnorm

    def _clip(self, g, gnorm, trigger):
        """optax's ``clip_by_global_norm``: ``g`` under the limit, else
        ``g / norm * limit`` (selected on the device, no host sync)."""
        if trigger is None:
            return g
        clipped = (g / gnorm.to(g.dtype)) * self.cfg.clip_norm
        return torch.where(trigger, g, clipped)


class FusedAdamW:
    """AdamW whose whole step — clip scale, moments, bias correction,
    weight decay, apply — is one elementwise expression per leaf (the JAX
    package's ``FusedAdamW``); ``nu`` is fp32 whatever the parameter
    dtype."""

    def __init__(self, cfg: OptimizerConfig, schedule: Callable[[int], float]):
        self.cfg = cfg
        self.schedule = schedule

    def init(self, params: Any) -> dict:
        mu_dt = torch_dtype(self.cfg.mu_dtype) if self.cfg.mu_dtype else None
        return {
            "count": 0,
            "mu": T.map_tree(lambda p: torch.zeros_like(
                p, dtype=mu_dt or p.dtype, requires_grad=False), params),
            "nu": T.map_tree(lambda p: torch.zeros_like(
                p, dtype=torch.float32, requires_grad=False), params),
        }

    @torch.no_grad()
    def apply(self, grads: Any, opt_state: dict, params: Any,
              gnorm: Optional[torch.Tensor] = None):
        c = self.cfg
        count = int(opt_state["count"])
        lr = _f32(self.schedule(count), T.leaves(params)[0])
        gnorm = global_norm(grads) if gnorm is None else gnorm
        scale = torch.ones_like(gnorm)
        if c.clip_norm is not None:
            scale = torch.minimum(scale, c.clip_norm
                                  / torch.clamp(gnorm, min=1e-12))
        n = _f32(float(count + 1), gnorm)
        bc1 = 1.0 - _f32(c.b1, gnorm) ** n
        bc2 = 1.0 - _f32(c.b2, gnorm) ** n
        for p, g, m, v in zip(T.leaves(params), T.leaves(grads),
                              T.leaves(opt_state["mu"]),
                              T.leaves(opt_state["nu"])):
            g = g.float() * scale
            m32 = m.float() * c.b1 + (1.0 - c.b1) * g
            v.copy_(v * c.b2 + (1.0 - c.b2) * g * g)
            update = (m32 / bc1) / (torch.sqrt(v / bc2) + c.eps) \
                + c.weight_decay * p.float()
            p.copy_((p.float() - lr * update).to(p.dtype))
            m.copy_(m32.to(m.dtype))
        return params, {**opt_state, "count": count + 1}, gnorm


def make_optimizer(cfg: OptimizerConfig):
    sched = make_schedule(cfg)
    if cfg.fused:
        if cfg.name != "adamw":
            raise ValueError("fused=True supports adamw only")
        return FusedAdamW(cfg, sched)
    return ChainOptimizer(cfg, sched)


def apply_optimizer(optimizer, grads: Any, opt_state: dict, params: Any,
                    gnorm: Optional[torch.Tensor] = None):
    """One update for either optimizer kind: ``(params, opt_state,
    grad_norm)``, the norm of the unclipped gradients (``gnorm`` when the
    caller computed it: a sharded state's global norm). Parameters and
    moments are updated in place."""
    return optimizer.apply(grads, opt_state, params, gnorm)
