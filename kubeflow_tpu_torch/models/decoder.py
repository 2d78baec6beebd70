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

Under a mesh (``runtime/mesh.py``, training) ``decoder_loss`` takes this
rank's batch rows, cuts its part of the sequence after the input/target
shift, carries the part's offset into the positions, reads the params
through ``parallel.collectives.GatheredParams`` (a sharded leaf is
all-gathered where it is used, per layer) and returns this rank's part of
the global masked mean. A ``model`` axis runs the layers on the rank's
heads, mlp columns and vocab rows (``layers.py``), and the loss on its
vocab columns: each branch's vocab-parallel CE
(``parallel/vocab_parallel.py``: ``vocab_parallel_ce`` on the logits,
``fused_ce`` over the kernels) combines the ranks' per-row statistics.
``decoder_forward`` (the serving callers) all-gathers the logits over the
axis.
``decoder_param_specs`` gives every leaf's logical axes (JAX's spec
tree).
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts,
    noop_context_fn,
)

from kubeflow_tpu_torch.models import layers as L
from kubeflow_tpu_torch.models.config import (
    DecoderConfig, model_axis_of, with_model_axis,
)
from kubeflow_tpu_torch.ops import fused_xent
from kubeflow_tpu_torch.ops.flash_attention import flash_fwd_op
from kubeflow_tpu_torch.ops.quantization import (
    QuantizedTensor, check_quantize, contraction_dims, quantize_weight,
)
from kubeflow_tpu_torch.parallel import collectives as C
from kubeflow_tpu_torch.parallel import vocab_parallel as VP

Params = dict[str, Any]
#: The balance loss's weight in ``decoder_loss`` (the JAX default).
AUX_LOSS_WEIGHT = 0.01


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


def _stacked(gen: torch.Generator, n: int, make, quant=None,
             shard=None, path: str = "", keep: Optional[range] = None
             ) -> Any:
    """Stack ``n`` per-layer trees drawn one layer at a time from ``make``
    into ``[L, ...]`` leaves: only one layer's draw is alive at once, so a
    full-width model never holds its fp32 draws all together. ``quant``
    (leaf name → stacked contraction dims, or None) quantizes each named
    leaf as soon as it is drawn (``make(post)`` maps each leaf through
    ``post`` before drawing the next): only one leaf's full-dtype draw is
    alive at once. Per-output-channel scales never reduce over the layer
    axis, so the result is bit for bit the quantization of the stacked
    draw. ``shard(path, t)`` (a sharded train state) keeps each layer's
    block of each leaf as it is drawn, ``path`` the stacked leaf's; of
    the ``n`` layers drawn only ``keep``'s are stacked (a pipeline
    stage's)."""
    def post(name: str, t):
        if quant is not None and quant.get(name) is not None:
            t = quantize_weight(t, tuple(d - 1 for d in quant[name]))
        if shard is not None:
            return shard(f"{path}/{name}", t)
        return t

    def draw():
        tree = make(post)
        if shard is not None and not isinstance(tree, dict):
            tree = shard(path, tree)
        return tree

    # Layer 0's draw shapes the stacks, is copied in, then dropped: no
    # layer's draw outlives its copy.
    keep = range(n) if keep is None else keep
    tree = draw()
    out = ({k: _empty_like_stacked(len(keep), t) for k, t in tree.items()}
           if isinstance(tree, dict)
           else _empty_like_stacked(len(keep), tree))
    for i in range(n):
        if i:
            tree = draw()
        if i in keep:
            at = i - keep.start
            if isinstance(tree, dict):
                for k, t in tree.items():
                    _copy_layer(out[k], at, t)
            else:
                _copy_layer(out, at, tree)
        del tree
    return out


def init_decoder_params(gen: torch.Generator, cfg: DecoderConfig, *,
                        dtype: Optional[torch.dtype] = None,
                        quantize: Optional[str] = None,
                        shard=None, layers: Optional[range] = None
                        ) -> Params:
    """Random weights from ``gen`` on ``gen``'s device: truncated normal with
    the JAX package's fan-in scales, stored in ``dtype`` (default
    ``cfg.param_dtype``). The values differ from ``jax.random``'s — tests
    carry JAX-initialised weights across with ``convert.params_from_jax``.

    ``quantize="int8"``: each layer's matmul weights (and an untied
    lm_head) are packed into int8 ``QuantizedTensor``s as they are drawn,
    equal bit for bit to ``quantize_params_int8`` of the full-dtype draw;
    the full-dtype tree never exists.

    ``shard(path, t)`` returns the block of a leaf (or of one layer of a
    stacked leaf) that this process keeps: each is cut as soon as it is
    drawn (and packed, when quantizing: a ``QuantizedTensor`` is cut per
    field, keeping the whole leaf's scales), so the values are the whole
    draw's bit for bit while at most one whole leaf is alive
    (``train/step.py``'s sharded init, a tensor-parallel engine's).
    ``layers`` (a range of layer indices, default all): the stacked
    layers kept, every layer drawn (a pipeline stage's block)."""
    check_quantize(quantize)
    keep = shard if shard is not None else (lambda path, t: t)
    dt = dtype or cfg.weight_dtype
    dev = gen.device
    params: Params = {"embed": keep("embed", L.init_embedding(gen, cfg, dt))}
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
                         quant("attn", ("wq", "wk", "wv", "wo")),
                         shard, "layers/attn", layers),
        "mlp": _stacked(gen, n, lambda post: init_mlp(gen, cfg, dt, post),
                        quant("mlp", mlp_names), shard, "layers/mlp", layers),
        "ln1": _stacked(gen, n, lambda post: L.init_rmsnorm(cfg, dev, dt),
                        shard=shard, path="layers/ln1", keep=layers),
        "ln2": _stacked(gen, n, lambda post: L.init_rmsnorm(cfg, dev, dt),
                        shard=shard, path="layers/ln2", keep=layers),
    }
    params["final_norm"] = keep("final_norm", L.init_rmsnorm(cfg, dev, dt))
    if not cfg.tie_embeddings:
        head = L._init(gen, (cfg.hidden, cfg.vocab_size), dt)
        if quantize is not None:
            head = quantize_weight(head, (0,))
        params["lm_head"] = keep("lm_head", head)
    return params


def decoder_layout(cfg: DecoderConfig, mesh):
    """The params' ``sharding.ParamLayout`` on ``mesh`` by the training
    rules (``decoder_param_specs``; dims that do not divide replicated),
    from their shapes alone: its ``cut_leaf`` is ``init_decoder_params``'
    ``shard`` for this rank, its ``cut`` this rank's shards of a whole
    tree (what a tensor-parallel engine holds)."""
    from kubeflow_tpu_torch.parallel.sharding import ParamLayout

    return ParamLayout(mesh, decoder_param_specs(cfg),
                       abstract_decoder_params(cfg))


def abstract_decoder_params(cfg: DecoderConfig) -> Params:
    """``init_decoder_params``' tree as tensors on the ``meta`` device: every
    leaf's shape and dtype, with no storage and no draw (what JAX's
    ``eval_shape`` of the init gives). A sharded train state lays itself
    out from it before anything is drawn."""
    d, hd, n, m = cfg.hidden, cfg.head_dim, cfg.n_layers, cfg.mlp_dim
    attn = {"wq": (d, cfg.n_heads, hd), "wk": (d, cfg.n_kv_heads, hd),
            "wv": (d, cfg.n_kv_heads, hd), "wo": (cfg.n_heads, hd, d)}
    if cfg.is_moe:
        e = cfg.num_experts
        mlp = {"router": (d, e), "gate": (e, d, m), "up": (e, d, m),
               "down": (e, m, d)}
    else:
        mlp = {"gate": (d, m), "up": (d, m), "down": (m, d)}
    shapes = {"embed": (cfg.vocab_size, d),
              "layers": {"attn": {k: (n,) + v for k, v in attn.items()},
                         "mlp": {k: (n,) + v for k, v in mlp.items()},
                         "ln1": (n, d), "ln2": (n, d)},
              "final_norm": (d,)}
    if not cfg.tie_embeddings:
        shapes["lm_head"] = (d, cfg.vocab_size)

    def meta(t):
        if isinstance(t, dict):
            return {k: meta(v) for k, v in t.items()}
        return torch.empty(t, dtype=cfg.weight_dtype, device="meta")

    return meta(shapes)


def _block_specs(cfg: DecoderConfig) -> dict:
    """Logical-axis spec tree for one decoder block (JAX's
    ``_block_specs``)."""
    attn = {"wq": ("embed", "heads", "head_dim"),
            "wk": ("embed", "kv_heads", "head_dim"),
            "wv": ("embed", "kv_heads", "head_dim"),
            "wo": ("heads", "head_dim", "embed")}
    if cfg.is_moe:
        mlp = {"router": ("embed", None),
               "gate": ("expert", "embed", "expert_mlp"),
               "up": ("expert", "embed", "expert_mlp"),
               "down": ("expert", "expert_mlp", "embed")}
    else:
        mlp = {"gate": ("embed", "mlp"), "up": ("embed", "mlp"),
               "down": ("mlp", "embed")}
    return {"attn": attn, "mlp": mlp, "ln1": ("norm",), "ln2": ("norm",)}


def decoder_param_specs(cfg: DecoderConfig) -> dict:
    """Logical-axis spec tree mirroring ``init_decoder_params``' structure:
    the stacked layer axis prepends ``"layers"`` to every per-layer leaf."""
    def stack(t):
        if isinstance(t, dict):
            return {k: stack(v) for k, v in t.items()}
        return ("layers",) + t

    specs = {"embed": ("vocab", "embed_table"),
             "layers": stack(_block_specs(cfg)),
             "final_norm": ("norm",)}
    if not cfg.tie_embeddings:
        specs["lm_head"] = ("embed", "vocab")
    return specs


def layer_view(layers: Any, i: int) -> Any:
    """Layer ``i``'s params: a view ``[i]`` of every stacked leaf (of a
    ``GatheredParams`` tree, its layer ``i``, gathered where used)."""
    if isinstance(layers, dict):
        return {k: layer_view(v, i) for k, v in layers.items()}
    if hasattr(layers, "layer"):
        return layers.layer(i)
    return layers[i]


def _ffn_aux(bp: dict, h: torch.Tensor, cfg: DecoderConfig,
             valid_len=None, mesh=None):
    """The block's feed-forward half on the normed stream and its balance
    loss: ``(moe_block out, aux)`` for an MoE config (split over
    ``mesh``'s expert, model and token axes), ``(mlp out, None)`` for a
    dense one."""
    if cfg.is_moe:
        return L.moe_block(bp["mlp"], h, cfg, valid_len=valid_len,
                           mesh=mesh)
    return L.mlp_block(bp["mlp"], h, cfg), None


def ffn(bp: dict, h: torch.Tensor, cfg: DecoderConfig,
        valid_len=None) -> torch.Tensor:
    """``_ffn_aux``'s output alone: the serving steps, which need no
    balance loss."""
    return _ffn_aux(bp, h, cfg, valid_len)[0]


def _mlp_half(bp: dict, x: torch.Tensor, attn_out: torch.Tensor,
              cfg: DecoderConfig, valid_len=None, mesh=None):
    """The block's second half: ``(x + attn_out + ffn(norm(x + attn_out)),
    aux)``, aux the MoE block's balance loss (None for a dense config)."""
    # Residual add + second norm as ONE op (one kernel pass when on).
    x, h = L.add_rmsnorm(x, attn_out, bp["ln2"], cfg)
    out, aux = _ffn_aux(bp, h, cfg, valid_len, mesh)
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
                  attn_impl: str, lora: Optional[dict], valid_len,
                  mesh=None):
    """A cacheless block as three functions whose boundaries are
    ``block_outs``' kept tensors: ``qkv(x) -> (q_rope, k_rope, v_proj)``,
    ``attend(q, k, v) -> attn_out``, ``mlp(x, attn_out) -> (x, aux)``."""
    def qkv(x):
        return L.attention_qkv(bp["attn"], L.rmsnorm(x, bp["ln1"], cfg),
                               positions, cfg, lora)

    def attend(q, k, v):
        return L.attention_out(bp["attn"], q, k, v, cfg,
                               attn_impl=attn_impl, lora=lora, mesh=mesh)

    def mlp(x, attn_out):
        return _mlp_half(bp, x, attn_out, cfg, valid_len, mesh)

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
    mesh=None,
):
    """``_forward`` without the balance loss: (logits or hidden states,
    new caches), what the serving callers unpack. Under a model axis the
    logits are the whole vocabulary's (gathered over the axis). A
    ``mesh`` with a ``pipeline`` degree above 1 runs the layers staged
    (``staged_forward`` on this rank's shards, whole over ``fsdp``:
    contiguous positions, so custom ``positions`` raise, as JAX's do); a
    cache never takes that branch."""
    from kubeflow_tpu_torch.parallel.fsdp import pipelined

    if pipelined(mesh) and kv_caches is None:
        if positions is not None:
            raise NotImplementedError(
                "pipeline parallelism computes contiguous positions inside "
                "the stage; custom positions are not supported under pp>1")
        return staged_forward(params, tokens, cfg, mesh=mesh,
                              attn_impl=attn_impl, skip_head=skip_head), None
    out, caches, _ = _forward(params, tokens, cfg, positions=positions,
                              kv_caches=kv_caches, attn_impl=attn_impl,
                              skip_head=skip_head,
                              inputs_embeds=inputs_embeds, lora=lora,
                              valid_len=valid_len)
    if not skip_head:
        out = C.gather_from_model(out, model_axis_of(cfg), cfg.vocab_size)
    return out, caches


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
    mesh=None,
):
    """Returns (logits [B,S,V] float32, new_kv_caches|None, aux): aux is
    the MoE blocks' balance loss summed over the layers (fp32, 0-dim), None
    for a dense config; under a model axis the logits are the rank's vocab
    columns. With
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
        x = L.embed(params["embed"], tokens, cfg)
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
                                   valid_len, mesh)
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
    return head_logits(params, x, cfg), new_caches, aux_total


def _head(params: Params, cfg: DecoderConfig):
    """The output head ``[D, V]`` (the tied embedding's transpose), at this
    rank's vocab columns under a model axis (``layers.rank_cols``)."""
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return L.rank_cols(head, 1, cfg.vocab_size, cfg, "vocab")


def head_logits(params: Params, x: torch.Tensor,
                cfg: DecoderConfig) -> torch.Tensor:
    """Final-norm hidden [..., D] → fp32 logits [..., V] (softcapped when
    the config says so). The product runs in the activation dtype (fp32
    accumulation inside the matmul) and is widened to fp32 after it.
    Under a model axis: the rank's vocab columns, its input through
    ``copy_to_model``."""
    dt = cfg.activation_dtype
    logits = (C.copy_to_model(x, model_axis_of(cfg))
              @ L.weight(_head(params, cfg), dt)).float()
    if cfg.logits_softcap is not None:
        logits = torch.tanh(logits / cfg.logits_softcap) * cfg.logits_softcap
    return logits


def lm_head(params: Params, x: torch.Tensor, cfg: DecoderConfig) -> torch.Tensor:
    """``head_logits`` over the whole vocabulary: under a model axis the
    ranks' columns all-gathered (what sampling reads)."""
    return C.gather_from_model(head_logits(params, x, cfg),
                               model_axis_of(cfg), cfg.vocab_size)


def init_kv_caches(cfg: DecoderConfig, batch: int, max_len: int,
                   device) -> dict:
    """Contiguous decode cache, stacked over layers (on the kv heads this
    rank reads, under a model axis)."""
    shape = (cfg.n_layers, batch, max_len, len(L.local_kv_heads(cfg)),
             cfg.head_dim)
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
    lowest index, as ``jnp.argmax``'s do. Under a model axis ``head`` is
    the rank's vocab columns and each chunk's CE is vocab-parallel."""
    tp = model_axis_of(cfg)
    b, s, _ = hidden.shape
    chunk = min(cfg.loss_chunk_size, s)
    if s % chunk:
        chunk = s  # odd tails: fall back to one chunk
    cap = cfg.logits_softcap

    def body(hc: torch.Tensor, tc: torch.Tensor):
        logits = (C.copy_to_model(hc, tp) @ head).float()
        if cap is not None:
            logits = torch.tanh(logits / cap) * cap
        if tp is not None:
            return VP.vocab_parallel_ce(
                logits, tc, tp, L.model_part(cfg.vocab_size, cfg)[0])
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


def _nll(params: Params, hidden: torch.Tensor, targets: torch.Tensor,
         cfg: DecoderConfig, fused: bool):
    """Per-token (nll, correct) of the final-norm ``hidden`` [B,S,D]
    against ``targets`` [B,S], by the loss path ``decoder_loss`` picks:
    the fused CE (kernels 9–11), the chunked CE, or the dense logits;
    each vocab-parallel under a model axis."""
    tp = model_axis_of(cfg)
    v0 = L.model_part(cfg.vocab_size, cfg)[0]
    if fused or cfg.loss_chunk_size:
        head = _head(params, cfg).to(hidden.dtype)
        if fused and tp is not None:
            return VP.fused_ce(hidden, head, targets, tp,
                               logits_softcap=cfg.logits_softcap, offset=v0)
        if fused:
            return fused_xent.fused_cross_entropy(
                hidden, head, targets, logits_softcap=cfg.logits_softcap)
        return _chunked_ce(hidden, head, targets, cfg)
    logits = head_logits(params, hidden, cfg)
    if tp is not None:
        return VP.vocab_parallel_ce(logits, targets, tp, v0)
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, targets[..., None])[..., 0]
    return nll, (logits.argmax(-1) == targets).float()


def _rank_part(inputs: torch.Tensor, targets: torch.Tensor, loss_mask,
               mesh):
    """This rank's ``seq`` part of its rows' inputs, targets and mask, and
    the part's positions (offset by its start)."""
    from kubeflow_tpu_torch.parallel.collectives import seq_info

    _, idx, n = seq_info(mesh)
    s = inputs.shape[1]
    if s % n:
        raise ValueError(f"sequence length {s} does not divide over "
                         f"the seq axis ({n})")
    part = s // n
    cut = slice(idx * part, (idx + 1) * part)
    inputs, targets = inputs[:, cut], targets[:, cut]
    if loss_mask is not None:
        loss_mask = loss_mask[:, cut]
    positions = (torch.arange(part, device=inputs.device)
                 + idx * part)[None, :].expand(inputs.shape[0], part)
    return inputs, targets, loss_mask, positions


def decoder_loss(
    params: Params,
    tokens: torch.Tensor,        # [B, S+1]: input = [:, :-1], target = [:, 1:]
    cfg: DecoderConfig,
    *,
    loss_mask: Optional[torch.Tensor] = None,   # [B, S] 1.0 = count it
    attn_impl: str = "xla",
    aux_loss_weight: float = AUX_LOSS_WEIGHT,
    mesh=None,
    placements: Optional[dict] = None,
):
    """Next-token cross-entropy in fp32, plus ``aux_loss_weight`` times the
    MoE blocks' balance loss (summed over layers) for an MoE config.
    Returns ``(loss, metrics)`` with ``ce_loss``, ``aux_loss`` (0 for a
    dense config), ``tokens`` and ``accuracy`` (detached).

    Loss-path selection as in the JAX package (``_nll``): with fused
    kernels on (``layers.fused_kernels_on``) the fused CE (``fused_xent``,
    kernels 9–11), which never materializes the [B, S, V] logits on the
    card; otherwise ``cfg.loss_chunk_size`` streams the head in sequence
    chunks, and the dense branch materializes the full logits.

    Under ``mesh``, ``tokens`` (and ``loss_mask``, [B, S]) are this rank's
    batch rows; the rank keeps its ``seq`` part of the shifted inputs and
    targets, at positions offset by the part's start. ``placements``
    (each param leaf's gather dim, or None; ``train/step.py``) says which
    leaves are local shards, gathered at use over the ``fsdp`` group; a
    leaf's dim over ``model`` or ``expert`` stays local, and the ranks of
    one ``expert`` × ``model`` group read the same rows and compute the
    same loss. The sum of the nll and the token count are all-reduced over
    the batch and ``seq`` axes: the metrics are the global masked mean,
    and ``loss`` is this rank's part of it (the parts over the ranks sum
    to it), so the gradients summed over the ranks are the global mean's.
    An MoE config's balance loss is likewise this rank's part of the
    global batch's (``layers.moe_block``), and ``aux_loss`` the global
    value. A ``pipeline`` degree above 1 stages the layers
    (``staged_loss``)."""
    from kubeflow_tpu_torch.parallel.fsdp import pipelined

    if pipelined(mesh):
        return staged_loss(params, tokens, cfg, loss_mask=loss_mask,
                           attn_impl=attn_impl,
                           aux_loss_weight=aux_loss_weight, mesh=mesh,
                           placements=placements)
    tokens = tokens.long()
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    positions = None
    loss_group = None
    if mesh is not None:
        from kubeflow_tpu_torch.parallel.collectives import (
            GatheredParams, axis_group,
        )
        from kubeflow_tpu_torch.parallel.fsdp import TOKEN_AXES, check_mesh

        check_mesh(mesh)
        inputs, targets, loss_mask, positions = _rank_part(
            inputs, targets, loss_mask, mesh)
        if placements is not None:
            params = GatheredParams(params, placements,
                                    axis_group(mesh, ("fsdp",)))
        loss_group = axis_group(mesh, TOKEN_AXES)
        cfg = with_model_axis(cfg, C.model_axis(mesh))
    fused = L.fused_kernels_on(cfg, inputs)
    hidden, _, aux = _forward(params, inputs, cfg, skip_head=True,
                              positions=positions, attn_impl=attn_impl,
                              mesh=mesh)
    nll, correct = _nll(params, hidden, targets, cfg, fused)
    if loss_mask is None:
        loss_mask = torch.ones_like(nll)
    loss_mask = loss_mask.to(nll.dtype)
    nll_sum = (nll * loss_mask).sum()
    hits = (correct * loss_mask).sum()
    count = loss_mask.sum()
    aux_part = (torch.zeros((), dtype=torch.float32, device=nll.device)
                if aux is None else aux)
    if loss_group is not None:
        sums = torch.stack([nll_sum.detach(), count, hits,
                            aux_part.detach()])
        torch.distributed.all_reduce(sums, group=loss_group)
        nll_total, count, hits, aux_total = sums.unbind(0)
    else:
        nll_total, aux_total = nll_sum, aux_part
    denom = torch.clamp(count, min=1.0)
    ce = nll_sum / denom
    ce_total = nll_total / denom
    loss = ce if aux is None else ce + aux_loss_weight * aux
    metrics = {
        "ce_loss": ce_total.detach(),
        "aux_loss": aux_total.detach(),
        "tokens": denom.detach(),
        "accuracy": (hits / denom).detach(),
    }
    return loss, metrics


# -- pipeline parallelism: the staged branch -----------------------------------

def check_stages(cfg: DecoderConfig, sizes: dict) -> int:
    """The stage count of a mesh of ``sizes`` for ``cfg`` (JAX's refusals
    of its staged branch): ``pipeline`` must divide the layers, and under
    ``model`` the degree must divide the heads, kv heads and MLP columns
    (this path shards them whole, with no replication), and under
    ``expert`` the degree must divide the experts (JAX's stage
    ``shard_map`` refuses a leaf whose dim does not divide)."""
    n = int(sizes.get("pipeline", 1))
    tp = int(sizes.get("model", 1))
    ep = int(sizes.get("expert", 1))
    if cfg.is_moe and ep > 1 and cfg.num_experts % ep:
        raise ValueError(
            "shard_map applied to the function 'worker' was given argument "
            "arrays with axis sizes that are not evenly divisible by the "
            f"corresponding mesh axis sizes: the {cfg.num_experts} experts "
            f"over mesh axis 'expert' (of size {ep})")
    if tp > 1 and (cfg.n_heads % tp or cfg.n_kv_heads % tp
                   or cfg.mlp_dim % tp):
        raise ValueError(
            f"model={tp} must divide n_heads={cfg.n_heads}, "
            f"n_kv_heads={cfg.n_kv_heads} and mlp_dim={cfg.mlp_dim} "
            "for pipeline x TP")
    if cfg.n_layers % n:
        raise ValueError(
            f"pipeline={n} must divide n_layers={cfg.n_layers}")
    return n


class _StagedLoss(torch.autograd.Function):
    """The staged loss's value, whose backward hands each param leaf the
    gradient the schedule already summed (scaled by the loss's
    cotangent)."""

    @staticmethod
    def forward(ctx, value, grads, *leaves):
        ctx.grads = grads
        return value.clone()

    @staticmethod
    def backward(ctx, g):
        # The summed gradients are the loss's alone: scaled in place.
        grads, ctx.grads = ctx.grads, None
        return (None, None, *(x.mul_(g) for x in grads))


def _stage_fn(cfg: DecoderConfig, positions: torch.Tensor, attn_impl: str,
              first_layer: int, n_layers: int, mesh) -> Callable:
    """A stage's work on one microbatch: layers ``first_layer`` …
    ``+ n_layers`` of ``params["layers"]`` on the streamed ``[x]`` (an
    MoE config streams ``[x, aux]``, aux [mb, 1] fp32 gaining the stage's
    balance losses, JAX's ``xs["aux"]``)."""
    def fn(params, xs):
        h = xs[0]
        pos = positions[:h.shape[0]]
        auxes = []
        for j in range(first_layer, first_layer + n_layers):
            stages = _block_stages(layer_view(params["layers"], j), pos, cfg,
                                   attn_impl, None, None, mesh)
            h, aux = _chain(stages)(h)
            auxes.append(aux)
        if not cfg.is_moe:
            return [h]
        return [h, xs[1] + torch.stack(auxes).sum()]

    return fn


class _Staging:
    """What the staged branch's entry points share: this rank's stages
    (its own of ``mesh``'s, or every one of ``stages`` in this process),
    its params (gathered at use over ``fsdp``) and config (with the
    ``model`` axis), its ``seq`` part of the inputs at their positions,
    the microbatch count and size, the first stage's ``feed`` and
    ``run`` (the schedule, through point-to-point calls or in
    lockstep)."""

    def __init__(self, params, inputs, targets, loss_mask, cfg, mesh,
                 placements, stages):
        from kubeflow_tpu_torch.parallel import pipeline as PP
        from kubeflow_tpu_torch.parallel.collectives import (
            GatheredParams, axis_group, pipeline_axis, seq_info,
        )
        from kubeflow_tpu_torch.parallel.fsdp import BATCH_AXES
        from kubeflow_tpu_torch.parallel.sharding import mesh_shape

        self.mesh, self.dp, self.seq_n = mesh, 1, 1
        if mesh is not None:
            sizes = mesh_shape(mesh)
            self.n = check_stages(cfg, sizes)
            inputs, targets, loss_mask, positions = _rank_part(
                inputs, targets, loss_mask, mesh)
            if placements is not None:
                params = GatheredParams(params, placements,
                                        axis_group(mesh, ("fsdp",)))
            cfg = with_model_axis(cfg, C.model_axis(mesh))
            self.axis = pipeline_axis(mesh)
            self.mine = [self.axis.stage]
            for a in BATCH_AXES:
                self.dp *= int(sizes.get(a, 1))
            self.seq_n = seq_info(mesh)[2]
        else:
            self.n = check_stages(cfg, {"pipeline": stages})
            b, s = inputs.shape
            positions = torch.arange(s, device=inputs.device)[None, :] \
                .expand(b, s)
            self.mine = list(range(self.n))
        self.params, self.cfg, self.positions = params, cfg, positions
        self.inputs, self.targets, self.loss_mask = inputs, targets, loss_mask
        self.b = inputs.shape[0]
        self.m = PP.microbatches(self.b * self.dp, self.dp, self.n,
                                 cfg.pipeline_schedule)
        self.mb = self.b // self.m

    def feed(self, i: int) -> list:
        """Microbatch ``i`` embedded (and, for MoE, its zero balance-loss
        rows)."""
        cfg, mb = self.cfg, self.mb
        x = L.embed(self.params["embed"], self.inputs[i * mb:(i + 1) * mb],
                    cfg)
        if cfg.embed_scale:
            x = x * L.embed_scale_value(cfg)
        if cfg.is_moe:
            return [x, torch.zeros((mb, 1), dtype=torch.float32,
                                   device=x.device)]
        return [x]

    def run(self, feed, sink, attn_impl: str, leaves, grad: bool,
            around=None) -> list:
        """The schedule over this rank's stages; returns their
        ``pipeline.Stage``s (their summed gradients)."""
        from kubeflow_tpu_torch.parallel import pipeline as PP

        cfg, n, per = self.cfg, self.n, self.cfg.n_layers // self.n
        work = [PP.Stage(
            _stage_fn(cfg, self.positions, attn_impl,
                      st * per if self.mesh is None else 0, per, self.mesh),
            self.params, stage=st, n=n, feed=feed, sink=sink, leaves=leaves,
            grad=grad, checkpoint_stages=cfg.remat_policy != "none")
            for st in self.mine]
        programs = [PP.stage_program(st, n, self.m, cfg.pipeline_schedule,
                                     w.forward, w.backward if grad else None)
                    for st, w in zip(self.mine, work)]
        if self.mesh is None:
            PP.run_lockstep(programs, around)
        else:
            template = [((self.mb, self.inputs.shape[1], cfg.hidden),
                         cfg.activation_dtype)]
            if cfg.is_moe:
                template.append(((self.mb, 1), torch.float32))
            PP.run_stage(programs[0], PP.PipeLink(
                self.axis, template, self.inputs.device))
        return work


def staged_forward(params: Params, tokens: torch.Tensor, cfg: DecoderConfig,
                   *, mesh=None, stages: Optional[int] = None,
                   attn_impl: str = "xla", skip_head: bool = False
                   ) -> torch.Tensor:
    """The decoder's forward with the layers staged (``staged_loss``'s
    schedule, forwards only, recording no gradient): the final-norm hidden
    states, or the fp32 logits over the whole vocabulary, of ``tokens``
    (this rank's rows; under ``seq``, of its part of the positions) on
    every rank, sent from the last stage over the pipeline group as JAX
    collects its pipeline's output."""
    with torch.no_grad():
        st = _Staging(params, tokens, tokens, None, cfg, mesh, None, stages)
        outs = {}

        def sink(i, ys):
            outs[i] = ys[0]
            return [ys[0]], None

        st.run(st.feed, sink, attn_impl, [], False)
        if mesh is None:
            x = torch.cat([outs[i] for i in range(st.m)])
        else:
            axis = st.axis
            x = (torch.cat([outs[i] for i in range(st.m)])
                 if axis.stage == axis.size - 1 else torch.empty(
                     (st.b, st.inputs.shape[1], st.cfg.hidden),
                     dtype=st.cfg.activation_dtype,
                     device=st.inputs.device))
            torch.distributed.broadcast(x, src=axis.ranks[-1],
                                        group=axis.group)
        x = L.rmsnorm(x, st.params["final_norm"], st.cfg)
        if skip_head:
            return x
        return lm_head(st.params, x, st.cfg)


def staged_loss(params: Params, tokens: torch.Tensor, cfg: DecoderConfig, *,
                loss_mask: Optional[torch.Tensor] = None,
                attn_impl: str = "xla",
                aux_loss_weight: float = AUX_LOSS_WEIGHT, mesh=None,
                placements: Optional[dict] = None,
                stages: Optional[int] = None,
                around: Optional[Callable] = None):
    """``decoder_loss`` with the layers staged over a ``pipeline`` axis
    (``parallel/pipeline.py``; JAX's ``_pipeline_layers`` under
    ``decoder_loss(mesh=)``): this rank's stage of ``mesh``, its
    neighbours over point-to-point calls, or, without a mesh, ``stages``
    stages of whole ``params`` in this process (``run_lockstep``).

    The first stage embeds each microbatch; each stage runs its
    ``n_layers / n`` layers on the streamed activation (the block inside a
    stage splits over ``seq``, ``model`` and ``expert`` as the unstaged
    block does, but an MoE block plans over the stage's microbatch alone,
    and its balance loss streams with the rows and is averaged over them,
    as JAX's stage ``shard_map`` does); the last stage applies the final
    norm, the head and the CE (``_nll``) per microbatch, each
    microbatch's loss its masked nll sum over the global token count,
    plus ``aux_loss_weight`` times its rows' balance loss over the global
    rows, so the microbatches' gradients sum to the unstaged mean's.
    ``cfg.pipeline_schedule`` ("gpipe" or "1f1b") orders the work, with
    JAX's microbatch count (``pipeline.microbatches``);
    ``cfg.remat_policy != "none"`` recomputes each
    stage's forward in its backward (JAX's ``checkpoint_stages``).

    While autograd records, the schedule runs every backward here: the
    returned ``loss`` carries each local param leaf's summed gradient
    (its backward hands them out), and its value is the global loss on
    every rank. The metrics are the global ones on every rank, summed
    over the batch, ``seq`` and ``pipeline`` axes from the last stage's."""
    from kubeflow_tpu_torch.parallel.collectives import axis_group
    from kubeflow_tpu_torch.parallel.fsdp import TOKEN_AXES
    from kubeflow_tpu_torch.train import tree as T

    tokens = tokens.long()
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    raw = params
    st = _Staging(params, inputs, targets, loss_mask, cfg, mesh, placements,
                  stages)
    params, cfg, inputs, targets, loss_mask = (
        st.params, st.cfg, st.inputs, st.targets, st.loss_mask)
    mb, b, dp, dev = st.mb, st.b, st.dp, inputs.device
    count_group = stat_group = None
    if mesh is not None:
        count_group = axis_group(mesh, TOKEN_AXES)
        stat_group = axis_group(mesh, TOKEN_AXES + ("pipeline",))
    if loss_mask is None:
        loss_mask = torch.ones(targets.shape, dtype=torch.float32, device=dev)
    loss_mask = loss_mask.float()
    count = loss_mask.sum()
    if count_group is not None:
        torch.distributed.all_reduce(count, group=count_group)
    denom = torch.clamp(count, min=1.0)
    leaves = T.leaves(raw)
    grad = torch.is_grad_enabled() and any(t.requires_grad for t in leaves)
    fused = L.fused_kernels_on(cfg, inputs)
    stats = torch.zeros(3, dtype=torch.float32, device=dev)

    def sink(i, ys):
        rows = slice(i * mb, (i + 1) * mb)
        hidden = L.rmsnorm(ys[0], params["final_norm"], cfg)
        nll, correct = _nll(params, hidden, targets[rows], cfg, fused)
        mask = loss_mask[rows]
        nll_sum = (nll * mask).sum()
        loss = nll_sum / denom
        part = [nll_sum.detach(), (correct * mask).sum().detach(),
                torch.zeros_like(nll_sum)]
        if cfg.is_moe:
            aux_sum = ys[1].sum()
            loss = loss + aux_loss_weight * aux_sum / (b * dp)
            part[2] = aux_sum.detach() / st.seq_n
        stats.add_(torch.stack(part))
        return [loss], None

    work = st.run(st.feed, sink, attn_impl, leaves, grad, around)
    if stat_group is not None:
        torch.distributed.all_reduce(stats, group=stat_group)
    nll_total, hits, aux_rows = stats.unbind(0)
    ce = nll_total / denom
    aux_total = aux_rows / (b * dp)
    value = ce + aux_loss_weight * aux_total if cfg.is_moe else ce
    metrics = {"ce_loss": ce, "aux_loss": aux_total, "tokens": denom,
               "accuracy": hits / denom}
    if not grad:
        return value, metrics
    grads = []
    for k, t in enumerate(leaves):
        got = [w.grads[k] for w in work if w.grads[k] is not None]
        grads.append(torch.stack(got).sum(0) if len(got) > 1 else
                     got[0] if got else torch.zeros_like(t))
    return _StagedLoss.apply(value, grads, *leaves), metrics
