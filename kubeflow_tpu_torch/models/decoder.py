"""The decoder LLM forward (port of ``kubeflow_tpu/models/decoder.py``,
forward only, dense).

Covers Llama-3 (RoPE+GQA+RMSNorm+SwiGLU) and Gemma ((1+w) norms, embed
scale, GeGLU, tied embeddings, logit softcap) through ``DecoderConfig``
flags. Layers are stacked on a leading ``[L, ...]`` axis exactly as the JAX
package's scanned layout, and traversed with a Python loop over per-layer
views. Remat and the training loss arrive with the training slice.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from kubeflow_tpu_torch.models import layers as L
from kubeflow_tpu_torch.models.config import DecoderConfig

Params = dict[str, Any]


def _stacked(gen: torch.Generator, n: int, make) -> Any:
    """Stack ``n`` per-layer trees drawn one layer at a time from ``make``
    into ``[L, ...]`` leaves: only one layer's draw is alive at once, so a
    full-width model never holds its fp32 draws all together."""
    first = make()
    if isinstance(first, dict):
        out = {k: torch.empty((n, *t.shape), dtype=t.dtype, device=t.device)
               for k, t in first.items()}
        for i in range(n):
            tree = first if i == 0 else make()
            for k, t in tree.items():
                out[k][i].copy_(t)
        return out
    out = torch.empty((n, *first.shape), dtype=first.dtype,
                      device=first.device)
    for i in range(n):
        out[i].copy_(first if i == 0 else make())
    return out


def init_decoder_params(gen: torch.Generator, cfg: DecoderConfig, *,
                        dtype: Optional[torch.dtype] = None) -> Params:
    """Random weights from ``gen`` on ``gen``'s device: truncated normal with
    the JAX package's fan-in scales, stored in ``dtype`` (default
    ``cfg.param_dtype``). The values differ from ``jax.random``'s — tests
    carry JAX-initialised weights across with ``convert.params_from_jax``."""
    if cfg.is_moe:
        raise NotImplementedError("MoE decoders arrive with the MoE slice")
    dt = dtype or cfg.weight_dtype
    dev = gen.device
    params: Params = {"embed": L.init_embedding(gen, cfg, dt)}
    n = cfg.n_layers
    params["layers"] = {
        "attn": _stacked(gen, n, lambda: L.init_attention(gen, cfg, dt)),
        "mlp": _stacked(gen, n, lambda: L.init_mlp(gen, cfg, dt)),
        "ln1": _stacked(gen, n, lambda: L.init_rmsnorm(cfg, dev, dt)),
        "ln2": _stacked(gen, n, lambda: L.init_rmsnorm(cfg, dev, dt)),
    }
    params["final_norm"] = L.init_rmsnorm(cfg, dev, dt)
    if not cfg.tie_embeddings:
        params["lm_head"] = L._init(gen, (cfg.hidden, cfg.vocab_size), dt)
    return params


def layer_view(layers: Any, i: int) -> Any:
    """Layer ``i``'s params: a view ``[i]`` of every stacked leaf."""
    if isinstance(layers, dict):
        return {k: layer_view(v, i) for k, v in layers.items()}
    return layers[i]


def _block_forward(bp: dict, x: torch.Tensor, positions: torch.Tensor,
                   cfg: DecoderConfig, kv_cache: Optional[dict] = None,
                   attn_impl: str = "xla", prefill: bool = False):
    h = L.rmsnorm(x, bp["ln1"], cfg)
    attn_out, new_cache = L.attention_block(
        bp["attn"], h, positions, cfg, kv_cache=kv_cache,
        attn_impl=attn_impl, prefill=prefill)
    # Residual add + second norm as ONE op (one kernel pass when on).
    x, h = L.add_rmsnorm(x, attn_out, bp["ln2"], cfg)
    x = x + L.mlp_block(bp["mlp"], h, cfg)
    return x, new_cache


def decoder_forward(
    params: Params,
    tokens: torch.Tensor,              # [B, S] integer
    cfg: DecoderConfig,
    *,
    positions: Optional[torch.Tensor] = None,
    kv_caches: Optional[dict] = None,  # {"k","v": [L,B,Smax,K,Dh], "len": int}
    attn_impl: str = "xla",
    skip_head: bool = False,
    lora: Optional[dict] = None,
):
    """Returns (logits [B,S,V] float32, new_kv_caches|None). With
    ``skip_head``, returns the final-norm hidden states [B,S,D] instead of
    logits. A cache is written in place: the returned caches hold the same
    tensors with ``len`` advanced. ``kv_caches["prefill"] = True`` marks a
    scratch cache whose start is 0 (the engine's bucketed prefill), which
    lets ``attn_impl="pallas"`` run the flash kernel."""
    if cfg.is_moe:
        raise NotImplementedError("MoE decoders arrive with the MoE slice")
    if lora is not None:
        raise NotImplementedError("LoRA adapters arrive with the LoRA slice")
    b, s = tokens.shape
    if positions is None:
        # Decode with a cache: absolute positions continue from its length.
        offset = int(kv_caches["len"]) if kv_caches is not None else 0
        positions = (torch.arange(s, device=tokens.device)
                     + offset)[None, :].expand(b, s)

    dt = cfg.activation_dtype
    x = params["embed"][tokens].to(dt)
    if cfg.embed_scale:
        x = x * L.embed_scale_value(cfg)

    prefill = bool(kv_caches.get("prefill", False)) if kv_caches else False
    new_caches = None
    for i in range(cfg.n_layers):
        cache = None
        if kv_caches is not None:
            cache = {"k": kv_caches["k"][i], "v": kv_caches["v"][i],
                     "len": kv_caches["len"]}
        x, _ = _block_forward(layer_view(params["layers"], i), x, positions,
                              cfg, kv_cache=cache, attn_impl=attn_impl,
                              prefill=prefill)
    if kv_caches is not None:
        new_caches = {"k": kv_caches["k"], "v": kv_caches["v"],
                      "len": int(kv_caches["len"]) + s}

    x = L.rmsnorm(x, params["final_norm"], cfg)
    if skip_head:
        return x, new_caches
    return lm_head(params, x, cfg), new_caches


def lm_head(params: Params, x: torch.Tensor, cfg: DecoderConfig) -> torch.Tensor:
    """Final-norm hidden [..., D] → fp32 logits [..., V] (softcapped when
    the config says so). The product runs in the activation dtype (fp32
    accumulation inside the matmul) and is widened to fp32 after it."""
    dt = cfg.activation_dtype
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = (x @ head.to(dt)).float()
    if cfg.logits_softcap is not None:
        logits = torch.tanh(logits / cfg.logits_softcap) * cfg.logits_softcap
    return logits


def init_kv_caches(cfg: DecoderConfig, batch: int, max_len: int,
                   device) -> dict:
    """Contiguous decode cache, stacked over layers."""
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=cfg.activation_dtype, device=device),
        "v": torch.zeros(shape, dtype=cfg.activation_dtype, device=device),
        "len": 0,
    }
