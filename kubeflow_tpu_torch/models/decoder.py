"""The decoder LLM: forward and training loss (port of
``kubeflow_tpu/models/decoder.py``, dense).

Covers Llama-3 (RoPE+GQA+RMSNorm+SwiGLU) and Gemma ((1+w) norms, embed
scale, GeGLU, tied embeddings, logit softcap) through ``DecoderConfig``
flags. Layers are stacked on a leading ``[L, ...]`` axis exactly as the JAX
package's scanned layout, and traversed with a Python loop over per-layer
views. While autograd records (training, no cache), each layer is
rematerialized per ``cfg.remat_policy`` through
``torch.utils.checkpoint`` (``_remat``). ``decoder_loss`` is the
next-token cross-entropy with the fused (``ops/fused_xent.py``, kernels
9–11, with fused kernels on), chunked (``_chunked_ce``) and dense
branches.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch
from torch.utils.checkpoint import checkpoint

from kubeflow_tpu_torch.models import layers as L
from kubeflow_tpu_torch.models.config import DecoderConfig
from kubeflow_tpu_torch.ops import fused_xent

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


#: Remat policies ``_remat`` runs; the JAX package's others are queued.
REMAT_POLICIES = ("none", "full", "nothing_saveable")
_REMAT_LATER = ("dots_saveable", "block_outs", "dots_no_batch", "dots_flash")


def _remat(fn: Callable, policy: str) -> Callable:
    """``fn`` rematerialized per ``policy`` (port of ``decoder._remat``).
    ``"none"`` saves every activation; ``"full"`` and ``"nothing_saveable"``
    save only the layer's inputs and replay the whole layer in the backward
    (``torch.utils.checkpoint``, non-reentrant; JAX's two policies save the
    same nothing). The name-based and dot-based policies need a
    saved-tensor selection the port does not have yet."""
    if policy == "none":
        return fn
    if policy in ("full", "nothing_saveable"):
        return lambda *args: checkpoint(fn, *args, use_reentrant=False)
    if policy in _REMAT_LATER:
        raise NotImplementedError(
            f"remat policy {policy!r} is not ported yet; use one of "
            f"{REMAT_POLICIES}")
    raise ValueError(f"unknown remat policy {policy!r}")


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
    # While autograd records a cacheless forward (training), each layer is
    # rematerialized per ``cfg.remat_policy``; its params reach autograd
    # through the closure. A cache is written in place.
    train = kv_caches is None and torch.is_grad_enabled()
    for i in range(cfg.n_layers):
        cache = None
        if kv_caches is not None:
            cache = {"k": kv_caches["k"][i], "v": kv_caches["v"][i],
                     "len": kv_caches["len"]}

        def block(x, bp=layer_view(params["layers"], i), cache=cache):
            return _block_forward(bp, x, positions, cfg, kv_cache=cache,
                                  attn_impl=attn_impl, prefill=prefill)[0]

        x = (_remat(block, cfg.remat_policy) if train else block)(x)
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


def _chunked_ce(hidden: torch.Tensor, head: torch.Tensor,
                targets: torch.Tensor, cfg: DecoderConfig):
    """Blockwise softmax-CE over sequence chunks, so only [B, chunk, V]
    logits are live at once; each chunk is checkpointed (the JAX
    ``@jax.checkpoint`` body), so the backward recomputes its logits.
    ``head`` [D, V] is already in the activation dtype. The product runs
    in that dtype and is widened to fp32 after it, as ``lm_head`` does.
    Returns (nll [B,S] f32, correct [B,S] f32); argmax ties go to the
    lowest index, as ``jnp.argmax``'s do."""
    b, s, _ = hidden.shape
    chunk = min(cfg.loss_chunk_size, s)
    if s % chunk:
        chunk = s  # odd tails: fall back to one chunk
    cap = cfg.logits_softcap

    def body(hc: torch.Tensor, tc: torch.Tensor):
        logits = (hc @ head).float()
        if cap is not None:
            logits = torch.tanh(logits / cap) * cap
        logz = torch.logsumexp(logits, dim=-1)
        picked = torch.gather(logits, -1, tc[..., None])[..., 0]
        correct = (logits.argmax(-1) == tc).float()
        return logz - picked, correct

    nll, correct = [], []
    for c0 in range(0, s, chunk):
        n, c = checkpoint(body, hidden[:, c0:c0 + chunk],
                          targets[:, c0:c0 + chunk], use_reentrant=False)
        nll.append(n)
        correct.append(c)
    return torch.cat(nll, dim=1), torch.cat(correct, dim=1)


def decoder_loss(
    params: Params,
    tokens: torch.Tensor,        # [B, S+1]: input = [:, :-1], target = [:, 1:]
    cfg: DecoderConfig,
    *,
    loss_mask: Optional[torch.Tensor] = None,   # [B, S] 1.0 = count it
    attn_impl: str = "xla",
):
    """Next-token cross-entropy in fp32. Returns ``(loss, metrics)`` with
    ``ce_loss``, ``aux_loss``, ``tokens`` and ``accuracy`` (detached).

    Loss-path selection as in the JAX package: with fused kernels on
    (``layers.fused_kernels_on``) the fused CE (``fused_xent``, kernels
    9–11), which never materializes the [B, S, V] logits on the card;
    otherwise ``cfg.loss_chunk_size`` streams the head in sequence chunks,
    and the dense branch materializes the full logits."""
    if cfg.is_moe:
        raise NotImplementedError("MoE decoders arrive with the MoE slice")
    tokens = tokens.long()
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    fused = L.fused_kernels_on(cfg, inputs)
    if fused or cfg.loss_chunk_size:
        hidden, _ = decoder_forward(params, inputs, cfg, attn_impl=attn_impl,
                                    skip_head=True)
        head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
        head = head.to(hidden.dtype)
        if fused:
            nll, correct = fused_xent.fused_cross_entropy(
                hidden, head, targets, logits_softcap=cfg.logits_softcap)
        else:
            nll, correct = _chunked_ce(hidden, head, targets, cfg)
    else:
        logits, _ = decoder_forward(params, inputs, cfg, attn_impl=attn_impl)
        logp = torch.log_softmax(logits.float(), dim=-1)
        nll = -torch.gather(logp, -1, targets[..., None])[..., 0]
        correct = (logits.argmax(-1) == targets).float()
    if loss_mask is None:
        loss_mask = torch.ones_like(nll)
    loss_mask = loss_mask.to(nll.dtype)
    denom = torch.clamp(loss_mask.sum(), min=1.0)
    ce = (nll * loss_mask).sum() / denom
    aux = torch.zeros((), dtype=torch.float32, device=nll.device)
    metrics = {
        "ce_loss": ce.detach(),
        "aux_loss": aux,
        "tokens": denom.detach(),
        "accuracy": ((correct * loss_mask).sum() / denom).detach(),
    }
    return ce, metrics
