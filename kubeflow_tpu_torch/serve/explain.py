"""Explainer hop — the third leg of the predictor/transformer/explainer
triad (port of ``kubeflow_tpu/serve/explain.py``).

The explainer differentiates THROUGH the served decoder, on the engine's
own params and device:

- ``grad_x_input``: embedding-gradient × embedding attribution. One
  forward picks the model's predicted next token; one backward through
  the decoder with respect to the *embedded* inputs scores every prompt
  token's contribution to that prediction (exact directional derivative,
  finite-difference-tested). On the card its backward runs the norm and
  SwiGLU backward kernels on serving weights that need no gradient.
- ``leave_one_out``: occlusion attribution. All S ablations run as ONE
  [S, S] batched forward, scoring each token by how much its removal
  drops the predicted token's log-probability.

Everything runs under ``torch.no_grad()`` except the saliency's backward.
An MoE model explains on its dense path (``attribution_cfg``), as the JAX
server does: dispatch MoE's shared capacity buffers would couple the
ablation rows and make a saliency depend on capacity luck.

Under a model axis (a tensor-parallel engine) every rank runs the same
handler on its shards, through the engine's op stream (``LLMEngine.
explain``): the embeddings are looked up vocab-parallel (whole on every
rank), the head's logits are gathered over the vocabulary
(``lm_head``), whose backward gives each rank its columns' gradient, so
the log-softmax, the target and the gradient with respect to the
embeddings are the whole model's on every rank. The op carries the
handler's name and config (``handler_of``); each rank resolves it.
Attention takes the plain path (``decoder_forward``'s default
``attn_impl``), as the JAX module's does; the norm and SwiGLU take the
fused kernels wherever ``layers.fused_kernels_on`` says so. Handlers are
registered like transformers (name or "module:function").
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional

import torch

from kubeflow_tpu_torch.models import layers as L
from kubeflow_tpu_torch.models.config import DecoderConfig
from kubeflow_tpu_torch.models.decoder import decoder_forward, lm_head
from kubeflow_tpu_torch.runtime.entrypoints import resolve_handler

explainer_registry: dict[str, Callable] = {}


def register_explainer(name: str):
    def deco(fn: Callable) -> Callable:
        explainer_registry[name] = fn
        return fn
    return deco


def resolve_explainer(handler: str) -> Callable:
    return resolve_handler(handler, explainer_registry, "explainer")


def attribution_cfg(cfg: DecoderConfig) -> DecoderConfig:
    """``cfg`` on the dense MoE path (a dense model's as it is): the
    explanation of one prompt must not depend on what else shares a
    dispatch's expert capacity (JAX's ``ModelServer.explain_text``)."""
    if cfg.is_moe and cfg.moe_impl != "dense":
        return dataclasses.replace(cfg, moe_impl="dense")
    return cfg


def handler_of(explainer: Callable) -> tuple[str, dict]:
    """(the registered name or ``module:function`` path, config) of a
    ``build_explainer`` result: what another rank resolves it from."""
    fn, config = explainer, {}
    if isinstance(explainer, functools.partial):
        fn, config = explainer.func, dict(explainer.keywords)
    for name, f in explainer_registry.items():
        if f is fn:
            return name, config
    return f"{fn.__module__}:{fn.__name__}", config


def run_handler(handler: str, config: dict, tokens: list[int], *, params,
                cfg: DecoderConfig) -> dict:
    """The explainer ``handler`` (resolved here) with ``config`` on
    ``tokens``: one rank's part of a tensor-parallel explanation."""
    return resolve_explainer(handler)(tokens, params=params, cfg=cfg,
                                      **config)


def _last_logprobs(params, cfg, toks: torch.Tensor,
                   inputs_embeds: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """fp32 log-softmax of each row's last-position logits, [B, V]. The
    head runs on the last position only (the [B, S, V] logits are never
    built)."""
    hidden, _ = decoder_forward(params, toks, cfg, skip_head=True,
                                inputs_embeds=inputs_embeds)
    return torch.log_softmax(lm_head(params, hidden[:, -1], cfg).float(),
                             dim=-1)


def _predicted_target(params, cfg, toks: torch.Tensor) -> tuple[int, float]:
    """(argmax next token at the last position, its log-probability)."""
    with torch.no_grad():
        lp = _last_logprobs(params, cfg, toks)[0]
    target = int(lp.argmax())
    return target, float(lp[target])


def _tokens(tokens: list[int], params) -> torch.Tensor:
    return torch.tensor([tokens], dtype=torch.long,
                        device=params["embed"].device)


@register_explainer("grad_x_input")
def grad_x_input(tokens: list[int], *, params, cfg, **_) -> dict:
    """Saliency: score_i = <d logp(target)/d e_i, e_i> for each prompt
    embedding e_i — the first-order effect of removing token i."""
    toks = _tokens(tokens, params)
    target, lp_target = _predicted_target(params, cfg, toks)
    with torch.no_grad():
        # [1, S, D] in the activation dtype, before the embedding scale
        # (whole on every rank under a model axis).
        embeds = L.embed(params["embed"], toks, cfg)
    embeds.requires_grad_(True)
    with torch.enable_grad():
        lp = _last_logprobs(params, cfg, toks, inputs_embeds=embeds)
        (g,) = torch.autograd.grad(lp[0, target], embeds)
    scores = (g.float() * embeds.detach().float()).sum(-1)[0]
    return {
        "method": "grad_x_input",
        "target_token": target,
        "target_logprob": lp_target,
        "scores": [float(s) for s in scores.tolist()],
    }


@register_explainer("leave_one_out")
def leave_one_out(tokens: list[int], *, params, cfg,
                  ablate_token: int = 0, **_) -> dict:
    """Occlusion: score_i = logp(target | prompt) - logp(target | prompt
    with token i replaced by ``ablate_token``). One [S, S] forward."""
    s = len(tokens)
    toks = _tokens(tokens, params)
    target, lp_full = _predicted_target(params, cfg, toks)
    base = toks[0]
    eye = torch.eye(s, dtype=torch.bool, device=base.device)
    variants = torch.where(eye, torch.full_like(base, ablate_token),
                           base[None, :])                       # [S, S]
    with torch.no_grad():
        lps = _last_logprobs(params, cfg, variants)[:, target]
    return {
        "method": "leave_one_out",
        "target_token": target,
        "target_logprob": lp_full,
        "scores": [float(lp_full - v) for v in lps.tolist()],
    }


def build_explainer(conf: Optional[dict]) -> Optional[Callable]:
    """ExplainerSpec.{handler,config} → callable(tokens, params, cfg) →
    explanation dict. None config = no explainer hop."""
    if not conf:
        return None
    fn = resolve_explainer(conf.get("handler", "grad_x_input"))
    if conf.get("config"):
        fn = functools.partial(fn, **conf["config"])
    return fn
