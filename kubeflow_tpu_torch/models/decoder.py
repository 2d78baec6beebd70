"""The decoder LLM: forward and training loss (port of
``kubeflow_tpu/models/decoder.py``).

Covers Llama-3 (RoPE+GQA+RMSNorm+SwiGLU), Gemma ((1+w) norms, embed
scale, GeGLU, tied embeddings, logit softcap) and Mixtral (top-k MoE
blocks) through ``DecoderConfig`` flags. ``init_decoder_params(...,
quantize="int8")`` packs each layer's matmul weights into int8 as it draws
them (``ops/quantization.py``), so a model whose full-dtype weights would
not fit the card never holds them there. Layers are stacked on a leading
``[L, ...]`` axis exactly as the JAX package's scanned layout, and
traversed with a Python loop over per-layer views. While autograd records
(training, no cache), each layer is rematerialized per
``cfg.remat_policy`` through ``torch.utils.checkpoint``, selectively
for the policies that keep products or the flash outputs (``_remat``).
``decoder_loss`` is the next-token cross-entropy with the fused
(``ops/fused_xent.py``, kernels 9–11, with fused kernels on), chunked
(``_chunked_ce``) and dense branches; an MoE config adds
``aux_loss_weight`` times the MoE blocks' balance loss summed over the
layers (``_forward`` carries it out; ``decoder_forward`` keeps its
two-tuple for the serving callers).
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts,
    noop_context_fn,
)

from kubeflow_tpu_torch.models import layers as L
from kubeflow_tpu_torch.models.config import DecoderConfig
from kubeflow_tpu_torch.ops import fused_xent
from kubeflow_tpu_torch.ops.flash_attention import flash_fwd_op
from kubeflow_tpu_torch.ops.quantization import (
    QuantizedTensor, check_quantize, contraction_dims, quantize_weight,
)

Params = dict[str, Any]


def _empty_like_stacked(n: int, t) -> Any:
    """An uninitialised ``[n, ...]`` leaf shaped like one layer's ``t``."""
    if isinstance(t, QuantizedTensor):
        return QuantizedTensor(_empty_like_stacked(n, t.q),
                               _empty_like_stacked(n, t.scale))
    return torch.empty((n, *t.shape), dtype=t.dtype, device=t.device)


def _copy_layer(dst, i: int, t) -> None:
    if isinstance(dst, QuantizedTensor):
        dst.q[i].copy_(t.q)
        dst.scale[i].copy_(t.scale)
    else:
        dst[i].copy_(t)


def _stacked(gen: torch.Generator, n: int, make, quant=None) -> Any:
    """Stack ``n`` per-layer trees drawn one layer at a time from ``make``
    into ``[L, ...]`` leaves: only one layer's draw is alive at once, so a
    full-width model never holds its fp32 draws all together. ``quant``
    (leaf name → stacked contraction dims, or None) quantizes each named
    leaf as soon as it is drawn (``make(post)`` maps each leaf through
    ``post`` before drawing the next): only one leaf's full-dtype draw is
    alive at once. Per-output-channel scales never reduce over the layer
    axis, so the result is bit for bit the quantization of the stacked
    draw."""
    def post(name: str, t):
        if quant is None or quant.get(name) is None:
            return t
        return quantize_weight(t, tuple(d - 1 for d in quant[name]))

    def draw():
        return make(post)

    # Layer 0's draw shapes the stacks, is copied in, then dropped: no
    # layer's draw outlives its copy.
    tree = draw()
    out = ({k: _empty_like_stacked(n, t) for k, t in tree.items()}
           if isinstance(tree, dict) else _empty_like_stacked(n, tree))
    for i in range(n):
        if i:
            tree = draw()
        if isinstance(tree, dict):
            for k, t in tree.items():
                _copy_layer(out[k], i, t)
        else:
            _copy_layer(out, i, tree)
        del tree
    return out


def init_decoder_params(gen: torch.Generator, cfg: DecoderConfig, *,
                        dtype: Optional[torch.dtype] = None,
                        quantize: Optional[str] = None) -> Params:
    """Random weights from ``gen`` on ``gen``'s device: truncated normal with
    the JAX package's fan-in scales, stored in ``dtype`` (default
    ``cfg.param_dtype``). The values differ from ``jax.random``'s — tests
    carry JAX-initialised weights across with ``convert.params_from_jax``.

    ``quantize="int8"``: each layer's matmul weights (and an untied
    lm_head) are packed into int8 ``QuantizedTensor``s as they are drawn,
    equal bit for bit to ``quantize_params_int8`` of the full-dtype draw;
    the full-dtype tree never exists."""
    check_quantize(quantize)
    dt = dtype or cfg.weight_dtype
    dev = gen.device
    params: Params = {"embed": L.init_embedding(gen, cfg, dt)}
    n = cfg.n_layers

    def quant(block: str, names) -> Optional[dict]:
        if quantize is None:
            return None
        return {k: contraction_dims(("layers", block, k), cfg) for k in names}

    init_mlp = L.init_moe if cfg.is_moe else L.init_mlp
    mlp_names = ("router", "gate", "up", "down")
    params["layers"] = {
        "attn": _stacked(gen, n,
                         lambda post: L.init_attention(gen, cfg, dt, post),
                         quant("attn", ("wq", "wk", "wv", "wo"))),
        "mlp": _stacked(gen, n, lambda post: init_mlp(gen, cfg, dt, post),
                        quant("mlp", mlp_names)),
        "ln1": _stacked(gen, n, lambda post: L.init_rmsnorm(cfg, dev, dt)),
        "ln2": _stacked(gen, n, lambda post: L.init_rmsnorm(cfg, dev, dt)),
    }
    params["final_norm"] = L.init_rmsnorm(cfg, dev, dt)
    if not cfg.tie_embeddings:
        head = L._init(gen, (cfg.hidden, cfg.vocab_size), dt)
        params["lm_head"] = (head if quantize is None
                             else quantize_weight(head, (0,)))
    return params


def layer_view(layers: Any, i: int) -> Any:
    """Layer ``i``'s params: a view ``[i]`` of every stacked leaf."""
    if isinstance(layers, dict):
        return {k: layer_view(v, i) for k, v in layers.items()}
    return layers[i]


def _ffn_aux(bp: dict, h: torch.Tensor, cfg: DecoderConfig,
             valid_len=None):
    """The block's feed-forward half on the normed stream and its balance
    loss: ``(moe_block out, aux)`` for an MoE config, ``(mlp out, None)``
    for a dense one."""
    if cfg.is_moe:
        return L.moe_block(bp["mlp"], h, cfg, valid_len=valid_len)
    return L.mlp_block(bp["mlp"], h, cfg), None


def ffn(bp: dict, h: torch.Tensor, cfg: DecoderConfig,
        valid_len=None) -> torch.Tensor:
    """``_ffn_aux``'s output alone: the serving steps, which need no
    balance loss."""
    return _ffn_aux(bp, h, cfg, valid_len)[0]


def _mlp_half(bp: dict, x: torch.Tensor, attn_out: torch.Tensor,
              cfg: DecoderConfig, valid_len=None):
    """The block's second half: ``(x + attn_out + ffn(norm(x + attn_out)),
    aux)``, aux the MoE block's balance loss (None for a dense config)."""
    # Residual add + second norm as ONE op (one kernel pass when on).
    x, h = L.add_rmsnorm(x, attn_out, bp["ln2"], cfg)
    out, aux = _ffn_aux(bp, h, cfg, valid_len)
    return x + out, aux


def _block_forward(bp: dict, x: torch.Tensor, positions: torch.Tensor,
                   cfg: DecoderConfig, kv_cache: Optional[dict] = None,
                   attn_impl: str = "xla", prefill: bool = False,
                   lora: Optional[dict] = None, valid_len=None):
    """One decoder block: ``(x, new_cache, aux)``, aux the MoE block's
    balance loss (None for a dense config). Without a cache it is the
    chain of ``_block_stages``."""
    if kv_cache is None:
        x, aux = _chain(_block_stages(bp, positions, cfg, attn_impl, lora,
                                      valid_len))(x)
        return x, None, aux
    h = L.rmsnorm(x, bp["ln1"], cfg)
    attn_out, new_cache = L.attention_block(
        bp["attn"], h, positions, cfg, kv_cache=kv_cache,
        attn_impl=attn_impl, prefill=prefill, lora=lora)
    x, aux = _mlp_half(bp, x, attn_out, cfg, valid_len)
    return x, new_cache, aux


def _block_stages(bp: dict, positions: torch.Tensor, cfg: DecoderConfig,
                  attn_impl: str, lora: Optional[dict], valid_len):
    """A cacheless block as three functions whose boundaries are
    ``block_outs``' kept tensors: ``qkv(x) -> (q_rope, k_rope, v_proj)``,
    ``attend(q, k, v) -> attn_out``, ``mlp(x, attn_out) -> (x, aux)``."""
    def qkv(x):
        return L.attention_qkv(bp["attn"], L.rmsnorm(x, bp["ln1"], cfg),
                               positions, cfg, lora)

    def attend(q, k, v):
        return L.attention_out(bp["attn"], q, k, v, cfg,
                               attn_impl=attn_impl, lora=lora)

    def mlp(x, attn_out):
        return _mlp_half(bp, x, attn_out, cfg, valid_len)

    return qkv, attend, mlp


def _chain(stages) -> Callable:
    """The block of ``_block_stages``: ``x -> (x, aux)``."""
    qkv, attend, mlp = stages
    return lambda x: mlp(x, attend(*qkv(x)))


#: The JAX package's remat policies, all of which ``_remat`` runs.
REMAT_POLICIES = ("none", "full", "nothing_saveable", "dots_saveable",
                  "dots_no_batch", "dots_flash", "block_outs")

_aten = torch.ops.aten
#: Products without batch dimensions as the dispatcher sees them:
#: ``torch.matmul`` folds a [B, S, D] @ [D, M] product (and a broadcast
#: [1, T, D] @ [E, D, M]) into one ``mm``; JAX's ``dot_general`` with no
#: batch dims.
_DOTS_NO_BATCH = frozenset({_aten.mm.default, _aten.addmm.default})
#: Every product: those and the batched ones (``bmm``: the plain
#: attention's einsums, the dispatch path's expert products).
_DOTS = _DOTS_NO_BATCH | {_aten.bmm.default, _aten.baddbmm.default}
#: The ops whose outputs each selective policy keeps: JAX's
#: ``dots_saveable``, ``dots_with_no_batch_dims_saveable``, and that plus
#: the flash kernel's ``(o, lse)`` (JAX's ``flash_out`` and ``flash_lse``).
KEPT_OPS = {"dots_saveable": _DOTS, "dots_no_batch": _DOTS_NO_BATCH,
            "dots_flash": _DOTS_NO_BATCH | {flash_fwd_op}}


def _checkpointed(fn: Callable, context_fn=noop_context_fn) -> Callable:
    return lambda *args: checkpoint(fn, *args, use_reentrant=False,
                                    context_fn=context_fn)


def _keep_outputs_of(ops: frozenset) -> Callable:
    """A selective-checkpoint context: the outputs of ``ops`` are kept
    from the forward, every other op is replayed in the backward."""
    def policy(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if op in ops
                else CheckpointPolicy.PREFER_RECOMPUTE)

    return lambda: create_selective_checkpoint_contexts(policy)


def _remat(stages, policy: str) -> Callable:
    """A cacheless block, given as its ``_block_stages``, rematerialized
    per ``policy`` (port of ``decoder._remat``): ``x -> (x, aux)``. Every
    policy keeps the layer's input, as JAX's scan carry does:

    - ``"none"`` keeps every activation;
    - ``"full"`` and ``"nothing_saveable"`` keep nothing else and replay
      the whole layer in the backward (``torch.utils.checkpoint``,
      non-reentrant);
    - ``"dots_saveable"``, ``"dots_no_batch"`` and ``"dots_flash"`` keep
      the outputs of ``KEPT_OPS[policy]`` through PyTorch's selective
      checkpointing and replay the rest;
    - ``"block_outs"`` checkpoints the stages one by one, so the tensors
      between them (``q_rope``, ``k_rope``, ``v_proj``, ``attn_out``) are
      what the layer keeps. A stage's backward replays that stage, its
      products included (JAX's dead-code elimination skips the products
      whose outputs are kept). Names have no dispatcher op: a copying tag
      op would keep the same tensors at the price of a pass over each,
      and replay the layer whole.

    An unknown name raises ``ValueError``, as JAX's does."""
    if policy == "none":
        return _chain(stages)
    if policy in ("full", "nothing_saveable"):
        return _checkpointed(_chain(stages))
    if policy == "block_outs":
        return _chain([_checkpointed(f) for f in stages])
    if policy in KEPT_OPS:
        return _checkpointed(_chain(stages),
                             _keep_outputs_of(KEPT_OPS[policy]))
    raise ValueError(f"unknown remat policy {policy!r}; known: "
                     f"{REMAT_POLICIES}")


def decoder_forward(
    params: Params,
    tokens: torch.Tensor,              # [B, S] integer
    cfg: DecoderConfig,
    *,
    positions: Optional[torch.Tensor] = None,
    kv_caches: Optional[dict] = None,  # {"k","v": [L,B,Smax,K,Dh], "len": int}
    attn_impl: str = "xla",
    skip_head: bool = False,
    inputs_embeds: Optional[torch.Tensor] = None,
    lora: Optional[dict] = None,
    valid_len=None,
):
    """``_forward`` without the balance loss: (logits or hidden states,
    new caches), what the serving callers unpack."""
    return _forward(params, tokens, cfg, positions=positions,
                    kv_caches=kv_caches, attn_impl=attn_impl,
                    skip_head=skip_head, inputs_embeds=inputs_embeds,
                    lora=lora, valid_len=valid_len)[:2]


def _forward(
    params: Params,
    tokens: torch.Tensor,
    cfg: DecoderConfig,
    *,
    positions: Optional[torch.Tensor] = None,
    kv_caches: Optional[dict] = None,
    attn_impl: str = "xla",
    skip_head: bool = False,
    inputs_embeds: Optional[torch.Tensor] = None,
    lora: Optional[dict] = None,
    valid_len=None,
):
    """Returns (logits [B,S,V] float32, new_kv_caches|None, aux): aux is
    the MoE blocks' balance loss summed over the layers (fp32, 0-dim), None
    for a dense config. With
    ``skip_head``, returns the final-norm hidden states [B,S,D] instead of
    logits. A cache is written in place: the returned caches hold the same
    tensors with ``len`` advanced. ``kv_caches["prefill"] = True`` marks a
    scratch cache whose start is 0 (the engine's bucketed prefill), which
    lets ``attn_impl="pallas"`` run the flash kernel. ``inputs_embeds``
    [B,S,D] replaces the embedding lookup (pre-scale): the differentiable
    input the attribution explainers need (``serve/explain.py``);
    ``tokens`` still supplies shapes and positions. ``lora`` (multi-tenant
    serving, serve/lora.py): ``{"targets": {t: (a [L,S,din,r], b
    [L,S,r,dout])}, "aidx": [B], "scale": [S]}``; each row's adapter delta
    applies inside every attention block (rows with aidx = -1 add exact
    zero). ``valid_len`` (an int or [B]): positions at or past it are
    padding, which the MoE dispatch path keeps from claiming expert
    capacity (the serving prefill's buckets)."""
    b, s = tokens.shape
    if positions is None:
        # Decode with a cache: absolute positions continue from its length.
        offset = int(kv_caches["len"]) if kv_caches is not None else 0
        positions = (torch.arange(s, device=tokens.device)
                     + offset)[None, :].expand(b, s)

    dt = cfg.activation_dtype
    if inputs_embeds is not None:
        x = inputs_embeds.to(dt)
    else:
        x = params["embed"][tokens].to(dt)
    if cfg.embed_scale:
        x = x * L.embed_scale_value(cfg)

    prefill = bool(kv_caches.get("prefill", False)) if kv_caches else False
    new_caches = None
    # While autograd records a cacheless forward (training), each layer is
    # rematerialized per ``cfg.remat_policy``; its params reach autograd
    # through the closure. A cache is written in place.
    train = kv_caches is None and torch.is_grad_enabled()
    if cfg.remat_policy not in REMAT_POLICIES:
        raise ValueError(f"unknown remat policy {cfg.remat_policy!r}; "
                         f"known: {REMAT_POLICIES}")
    per_layer_aux = []
    for i in range(cfg.n_layers):
        bp, lr = layer_view(params["layers"], i), L.index_layer(lora, i)
        if kv_caches is None:
            stages = _block_stages(bp, positions, cfg, attn_impl, lr,
                                   valid_len)
            x, aux = (_remat(stages, cfg.remat_policy) if train
                      else _chain(stages))(x)
        else:
            cache = {"k": kv_caches["k"][i], "v": kv_caches["v"][i],
                     "len": kv_caches["len"]}
            x, _, aux = _block_forward(bp, x, positions, cfg,
                                       kv_cache=cache, attn_impl=attn_impl,
                                       prefill=prefill, lora=lr,
                                       valid_len=valid_len)
        if cfg.is_moe:
            per_layer_aux.append(aux)
    if kv_caches is not None:
        new_caches = {"k": kv_caches["k"], "v": kv_caches["v"],
                      "len": int(kv_caches["len"]) + s}
    # The JAX sum: the per-layer losses stacked, then reduced.
    aux_total = torch.stack(per_layer_aux).sum() if per_layer_aux else None

    x = L.rmsnorm(x, params["final_norm"], cfg)
    if skip_head:
        return x, new_caches, aux_total
    return lm_head(params, x, cfg), new_caches, aux_total


def lm_head(params: Params, x: torch.Tensor, cfg: DecoderConfig) -> torch.Tensor:
    """Final-norm hidden [..., D] → fp32 logits [..., V] (softcapped when
    the config says so). The product runs in the activation dtype (fp32
    accumulation inside the matmul) and is widened to fp32 after it."""
    dt = cfg.activation_dtype
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = (x @ L.weight(head, dt)).float()
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
    aux_loss_weight: float = 0.01,
):
    """Next-token cross-entropy in fp32, plus ``aux_loss_weight`` times the
    MoE blocks' balance loss (summed over layers) for an MoE config.
    Returns ``(loss, metrics)`` with ``ce_loss``, ``aux_loss`` (0 for a
    dense config), ``tokens`` and ``accuracy`` (detached).

    Loss-path selection as in the JAX package: with fused kernels on
    (``layers.fused_kernels_on``) the fused CE (``fused_xent``, kernels
    9–11), which never materializes the [B, S, V] logits on the card;
    otherwise ``cfg.loss_chunk_size`` streams the head in sequence chunks,
    and the dense branch materializes the full logits."""
    tokens = tokens.long()
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    fused = L.fused_kernels_on(cfg, inputs)
    if fused or cfg.loss_chunk_size:
        hidden, _, aux = _forward(params, inputs, cfg, attn_impl=attn_impl,
                                  skip_head=True)
        head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
        head = head.to(hidden.dtype)
        if fused:
            nll, correct = fused_xent.fused_cross_entropy(
                hidden, head, targets, logits_softcap=cfg.logits_softcap)
        else:
            nll, correct = _chunked_ce(hidden, head, targets, cfg)
    else:
        logits, _, aux = _forward(params, inputs, cfg, attn_impl=attn_impl)
        logp = torch.log_softmax(logits.float(), dim=-1)
        nll = -torch.gather(logp, -1, targets[..., None])[..., 0]
        correct = (logits.argmax(-1) == targets).float()
    if loss_mask is None:
        loss_mask = torch.ones_like(nll)
    loss_mask = loss_mask.to(nll.dtype)
    denom = torch.clamp(loss_mask.sum(), min=1.0)
    ce = (nll * loss_mask).sum() / denom
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=nll.device)
        loss = ce
    else:
        loss = ce + aux_loss_weight * aux
    metrics = {
        "ce_loss": ce.detach(),
        "aux_loss": aux.detach(),
        "tokens": denom.detach(),
        "accuracy": ((correct * loss_mask).sum() / denom).detach(),
    }
    return loss, metrics
