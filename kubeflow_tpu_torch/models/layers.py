"""Decoder building blocks — RMSNorm, RoPE, GQA attention, (Swi/Ge)GLU MLP,
top-k MoE, embedding — as plain functions over param dicts (port of
``kubeflow_tpu/models/layers.py``).

Params keep the JAX package's keys and layouts (``wq [D,H,Dh]``,
``wo [H,Dh,D]``, ``gate/up [D,M]``, ``down [M,D]``; MoE ``router [D,E]``,
``gate/up [E,D,M]``, ``down [E,M,D]``); projections are matmuls over
reshaped views of them. Compute follows the same dtype policy: every
weight read goes through ``weight``, which casts a tensor (or dequantizes
an int8 ``QuantizedTensor``) to the activation dtype at use;
norms/softmax/RoPE run in fp32. Multi-tenant LoRA deltas
(``lora_contrib``) add onto the attention projections. Under a mesh
(``runtime/mesh.py``) every tensor is this process's local block:
attention dispatches to ring or Ulysses attention over the ``seq`` axis
(``parallel/ring_attention.py``) as JAX's does; the fused norm, SwiGLU
and CE kernels run on the local blocks as they do on one device. Under a
``model`` axis (a config from ``config.with_model_axis``; JAX's manual
``tp_axis`` form) attention and the MLP are Megatron's: ``wq``/``wk``/
``wv`` and ``gate``/``up`` are column-parallel over the rank's heads and
mlp columns, their input passing ``copy_to_model``; ``wo`` and ``down``
are row-parallel, their partial outputs summed by ``reduce_from_model``;
norms stay whole on every rank; the embedding is vocab-parallel
(``embed``). GQA kv heads that do not divide over the axis are whole on
every rank, and each rank reads the kv heads its own q heads read
(``rank_kv``). The expert/sequence/tensor-parallel MoE axes are not
ported yet (they raise here).
"""

from __future__ import annotations

from typing import Optional

import torch

from kubeflow_tpu_torch.models.config import DecoderConfig, model_axis_of
from kubeflow_tpu_torch.ops import fused_norm
from kubeflow_tpu_torch.parallel import collectives as C
from kubeflow_tpu_torch.ops.attention import multi_head_attention
from kubeflow_tpu_torch.ops.quantization import QuantizedTensor


def _init(gen: torch.Generator, shape, dtype: torch.dtype,
          scale: Optional[float] = None) -> torch.Tensor:
    """Truncated-normal init in [-2, 2] with 1/sqrt(fan_in) default scale,
    drawn in fp32 on ``gen``'s device and cast to ``dtype``."""
    fan_in = shape[0] if len(shape) > 1 else shape[-1]
    scale = scale if scale is not None else fan_in ** -0.5
    t = torch.empty(shape, dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return t.mul_(scale).to(dtype)


def _keep(name: str, t):
    return t


def weight(w, dt: torch.dtype) -> torch.Tensor:
    """A weight as the operand of a product in ``dt``: an int8
    ``QuantizedTensor`` dequantizes, a tensor casts."""
    if isinstance(w, QuantizedTensor):
        return w.dequant(dt)
    return w.to(dt)


# -- Fused-kernel resolution ---------------------------------------------------

def fused_kernels_on(cfg: DecoderConfig, x: torch.Tensor) -> bool:
    """Resolve ``cfg.fused_kernels`` ("auto"|"on"|"off") for tensor ``x``:
    "auto" routes CUDA tensors through the hand-written kernels and keeps
    CPU tensors on the plain ops. The kernels carry their own backward
    (``autograd.Function``s), so serving and training take the same path.
    Under a mesh every tensor is the rank's local block, so the kernels
    run there too (JAX turns its kernels off on a mesh because GSPMD
    cannot partition them; the port has nothing to partition)."""
    fk = cfg.fused_kernels
    if fk == "on":
        return True
    if fk == "off":
        return False
    if fk != "auto":
        raise ValueError(f"unknown fused_kernels {fk!r} (auto|on|off)")
    return x.device.type == "cuda"


# -- RMSNorm -------------------------------------------------------------------

def init_rmsnorm(cfg: DecoderConfig, device, dtype=None) -> torch.Tensor:
    dt = dtype or cfg.weight_dtype
    if cfg.norm_plus_one:
        return torch.zeros((cfg.hidden,), dtype=dt, device=device)
    return torch.ones((cfg.hidden,), dtype=dt, device=device)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, cfg: DecoderConfig) -> torch.Tensor:
    if fused_kernels_on(cfg, x):
        return fused_norm.rmsnorm_fused(x, w, eps=cfg.norm_eps,
                                        plus_one=cfg.norm_plus_one)
    return fused_norm.rmsnorm_ref(x, w, eps=cfg.norm_eps,
                                  plus_one=cfg.norm_plus_one)


def add_rmsnorm(x: torch.Tensor, res: torch.Tensor, w: torch.Tensor,
                cfg: DecoderConfig):
    """The decoder-block residual idiom ``y = x + res; h = rmsnorm(y)`` as
    one op — one kernel pass when the kernels are on. Returns ``(y, h)``."""
    if fused_kernels_on(cfg, x):
        return fused_norm.add_rmsnorm_fused(x, res, w, eps=cfg.norm_eps,
                                            plus_one=cfg.norm_plus_one)
    y = x + res
    return y, rmsnorm(y, w, cfg)


# -- RoPE ----------------------------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding over split halves (not interleaved pairs).
    x: [B,S,H,D], positions: [B,S] (absolute)."""
    d = x.shape[-1]
    exps = -torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d
    freqs = torch.pow(theta, exps)                                    # [D/2]
    angles = positions[..., None].to(torch.float32) * freqs           # [B,S,D/2]
    cos = torch.cos(angles)[:, :, None, :]                            # [B,S,1,D/2]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# -- LoRA (multi-tenant adapters; serve/lora.py owns the registry) -------------

def lora_contrib(h: torch.Tensor, a_l: torch.Tensor, b_l: torch.Tensor,
                 aidx: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Batched per-row low-rank update: one gather + two batched products.

    ``h`` [B, S, d_in] (the same hidden the base projection consumes);
    ``a_l`` [S_adapters, d_in, r] / ``b_l`` [S_adapters, r, d_out]: one
    layer's packed adapter slices; ``aidx`` [B] adapter slot per row;
    ``scale`` [S_adapters] fp32. Both products return the activation dtype;
    the fp32 per-row scale then promotes the result. Rows with
    ``aidx < 0`` (base traffic) multiply by an exact 0.0, so their output
    is bit-unchanged when the result adds onto the base projection."""
    nslots = a_l.shape[0]
    safe = aidx.long().clamp(0, nslots - 1)
    a = a_l[safe]                                 # [B, d_in, r]
    b = b_l[safe]                                 # [B, r, d_out]
    s = scale[safe] * (aidx >= 0)
    t = torch.bmm(h, a)                           # "bsd,bdr->bsr"
    return torch.bmm(t, b) * s[:, None, None]     # "bsr,bro->bso"


def apply_lora_layer(lora_layer: Optional[dict], target: str,
                     h: torch.Tensor, base: torch.Tensor) -> torch.Tensor:
    """``base + delta`` for one projection (identity when the layer dict is
    None or the target isn't packed). ``lora_layer`` is ``{"targets": {t:
    (a_l, b_l)}, "aidx": [B], "scale": [S]}`` with per-layer [S, ...]
    slices; ``base`` is the projection output in its headed shape
    [B, S, H, Dh] (or [B, S, D] for wo), and the delta reshapes to it."""
    if lora_layer is None or target not in lora_layer["targets"]:
        return base
    a_l, b_l = lora_layer["targets"][target]
    delta = lora_contrib(h, a_l, b_l, lora_layer["aidx"],
                         lora_layer["scale"])
    # The fp32 scale promoted the delta: cast back so the cache write and
    # the residual keep the activation dtype.
    return base + delta.reshape(base.shape).to(base.dtype)


def slice_layers(lora: Optional[dict]) -> Optional[dict]:
    """The per-layer stacks of a packed-buffer dict: target -> (a
    [L,S,din,r], b [L,S,r,dout]), the L axis leading (what ``layer_view``
    rebinds one layer of). None passes through."""
    if lora is None:
        return None
    return {t: (lora["targets"][t][0], lora["targets"][t][1])
            for t in lora["targets"]}


def layer_view(lora: Optional[dict], layer_targets: Optional[dict],
               ) -> Optional[dict]:
    """Bind one layer's [S, ...] target slices to the batch-wide aidx and
    scale operands."""
    if lora is None:
        return None
    return {"targets": layer_targets, "aidx": lora["aidx"],
            "scale": lora["scale"]}


def index_layer(lora: Optional[dict], i: int) -> Optional[dict]:
    """Layer ``i``'s view of a packed-buffer dict (the forward's layer
    loop)."""
    if lora is None:
        return None
    return layer_view(lora, {t: (a[i], b[i])
                             for t, (a, b) in slice_layers(lora).items()})


# -- Tensor parallelism over the model axis ------------------------------------

def _split(whole: int, tp, what: str) -> int:
    """``whole`` columns of ``what`` over the axis: the rank's count."""
    if whole % tp.size:
        raise NotImplementedError(
            f"{what} {whole} does not divide over model = {tp.size}; the "
            "port splits heads, mlp columns and the vocabulary evenly "
            "(ROADMAP.md Queue 1)")
    return whole // tp.size


def local_heads(cfg: DecoderConfig) -> int:
    """The q heads this rank computes."""
    tp = model_axis_of(cfg)
    return cfg.n_heads if tp is None else _split(cfg.n_heads, tp, "heads")


def local_kv_heads(cfg: DecoderConfig) -> tuple[int, int]:
    """(first, count) of the kv heads this rank's q heads read: its split
    of them when they divide over the axis, else the one kv head its
    group of q heads shares (JAX replicates kv heads that do not divide;
    the rank's q heads must then lie in one GQA group)."""
    tp = model_axis_of(cfg)
    if tp is None:
        return 0, cfg.n_kv_heads
    if cfg.n_kv_heads % tp.size == 0:
        n = cfg.n_kv_heads // tp.size
        return tp.rank * n, n
    hl, group = local_heads(cfg), cfg.n_heads // cfg.n_kv_heads
    if group % hl:
        raise NotImplementedError(
            f"{cfg.n_kv_heads} kv heads over model = {tp.size}: rank's "
            f"{hl} q heads span several GQA groups of {group} "
            "(ROADMAP.md Queue 1)")
    return tp.rank * hl // group, 1


def rank_kv(w, cfg: DecoderConfig):
    """The kv heads this rank reads of a ``[D, K, Dh]`` leaf: the leaf as
    it is when it is the rank's split, its slice when it is whole."""
    first, n = local_kv_heads(cfg)
    if w.shape[1] == n:
        return w
    return w[:, first:first + n]


def _check_cut(local: int, whole: int, cfg: DecoderConfig, what: str) -> None:
    """A column-parallel leaf must be the rank's cut of the columns (a
    leaf left whole because its dim did not divide would be summed
    ``model`` times)."""
    tp = model_axis_of(cfg)
    if tp is not None and local != _split(whole, tp, what):
        raise ValueError(f"{what}: a leaf of {local} columns on a rank of "
                         f"model = {tp.size} (whole {whole})")


# -- Attention block -----------------------------------------------------------

def init_attention(gen: torch.Generator, cfg: DecoderConfig, dtype=None,
                   post=_keep) -> dict:
    """``post(name, leaf)`` maps each leaf as soon as it is drawn (the
    quantized draw packs it there), before the next draw; likewise for
    ``init_mlp`` and ``init_moe``."""
    dt = dtype or cfg.weight_dtype
    d = cfg.hidden
    return {
        "wq": post("wq", _init(gen, (d, cfg.n_heads, cfg.head_dim), dt)),
        "wk": post("wk", _init(gen, (d, cfg.n_kv_heads, cfg.head_dim), dt)),
        "wv": post("wv", _init(gen, (d, cfg.n_kv_heads, cfg.head_dim), dt)),
        "wo": post("wo", _init(gen, (cfg.n_heads, cfg.head_dim, d), dt,
                               scale=(cfg.n_heads * cfg.head_dim) ** -0.5)),
    }


def project(x: torch.Tensor, w, dt: torch.dtype) -> torch.Tensor:
    """``einsum("bsd,dhk->bshk")`` (or ``"bsd,dm->bsm"``) as one matmul over
    the weight's [D, rest] view."""
    b, s, d = x.shape
    out = x @ weight(w, dt).reshape(d, -1)
    return out.reshape(b, s, *w.shape[1:])


def out_project(attn: torch.Tensor, wo, dt: torch.dtype) -> torch.Tensor:
    """``einsum("bshk,hkd->bsd")``."""
    b, s = attn.shape[:2]
    return attn.reshape(b, s, -1) @ weight(wo, dt).reshape(-1, wo.shape[-1])


def attention_qkv(p: dict, x: torch.Tensor, positions: torch.Tensor,
                  cfg: DecoderConfig, lora: Optional[dict] = None):
    """The normed stream ``x`` [B,S,D] → ``(q, k, v)``: q and k after RoPE
    (JAX's ``q_rope`` and ``k_rope``), v as projected (``v_proj``), each
    with its adapter delta when ``lora`` is given."""
    dt = cfg.activation_dtype
    tp = model_axis_of(cfg)
    if tp is not None:
        _check_cut(p["wq"].shape[1], cfg.n_heads, cfg, "heads")
        x = C.copy_to_model(x, tp)
    q = project(x, p["wq"], dt)
    k = project(x, rank_kv(p["wk"], cfg), dt)
    v = project(x, rank_kv(p["wv"], cfg), dt)
    if lora is not None:
        q = apply_lora_layer(lora, "wq", x, q)
        k = apply_lora_layer(lora, "wk", x, k)
        v = apply_lora_layer(lora, "wv", x, v)
    return (rope(q, positions, cfg.rope_theta),
            rope(k, positions, cfg.rope_theta), v)


def attention_proj(p: dict, out: torch.Tensor, cfg: DecoderConfig,
                   lora: Optional[dict] = None) -> torch.Tensor:
    """The attention output [B,S,H,Dh] through ``wo`` (JAX's
    ``attn_out``); under a model axis the rank's heads give a partial sum,
    summed over the axis."""
    proj = out_project(out, p["wo"], cfg.activation_dtype)
    if lora is not None:
        b, s = out.shape[0], out.shape[1]
        proj = apply_lora_layer(lora, "wo", out.reshape(b, s, -1), proj)
    return C.reduce_from_model(proj, model_axis_of(cfg))


def attention_out(p: dict, q: torch.Tensor, k: torch.Tensor,
                  v: torch.Tensor, cfg: DecoderConfig, *,
                  attn_impl: str = "xla",
                  lora: Optional[dict] = None, mesh=None) -> torch.Tensor:
    """Causal attention over the block's own q, k and v (no cache), then
    the output projection: ``attn_out`` [B,S,D]. Under ``mesh`` q, k and v
    are this rank's batch rows and sequence part (``attend``)."""
    out = attend(q, k, v, attn_impl=attn_impl, mesh=mesh)
    return attention_proj(p, out, cfg, lora)


SEQ_PARALLEL_IMPLS = ("ring", "ring_flash", "ulysses")


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
           attn_impl: str = "xla", mesh=None) -> torch.Tensor:
    """Causal attention for a cacheless block, JAX's dispatch:

    - ``"ring"``, ``"ring_flash"`` and ``"ulysses"`` run sequence-parallel
      attention over the mesh's ``seq`` axis; without a mesh or with
      ``seq == 1``, one attention over the local sequence: the flash kernel
      on a CUDA tensor, plain attention on the CPU (JAX's plain path). The
      ring's block is the flash kernel on a CUDA tensor and the plain
      online-softmax step on the CPU;
      ``"ring_flash"`` takes the flash step on the CPU too (its kernels'
      plain versions), as JAX's forces the Pallas kernels;
    - their ``_local`` forms call the collective form directly;
    - any other impl runs per rank on the local batch and heads (the flash
      kernel per shard, as ``flash_attention_sharded``); on a sequence
      split, this rank's queries attend the K/V parts of the whole ``seq``
      group, all-gathered (reduce-scattered in the backward), from the
      part's absolute offset."""
    from kubeflow_tpu_torch.parallel.collectives import gather_dim, seq_info
    from kubeflow_tpu_torch.parallel import ring_attention as R

    group, idx, n = seq_info(mesh)
    impl = attn_impl.removesuffix("_local")
    if impl in SEQ_PARALLEL_IMPLS:
        if n == 1 and not attn_impl.endswith("_local"):
            return multi_head_attention(
                q, k, v, causal=True, impl="pallas" if q.is_cuda else "xla")
        if impl == "ulysses":
            return R.ulysses_attention(q, k, v, group, causal=True)
        return R.ring_attention(
            q, k, v, group, causal=True,
            impl="pallas" if impl == "ring_flash" else "auto")
    if n > 1:
        kf, vf = gather_dim(k, 1, group), gather_dim(v, 1, group)
        return multi_head_attention(q, kf, vf, causal=True,
                                    q_offset=idx * q.shape[1],
                                    impl=attn_impl)
    return multi_head_attention(q, k, v, causal=True, impl=attn_impl)


def attention_block(
    p: dict,
    x: torch.Tensor,                    # [B,S,D]
    positions: torch.Tensor,            # [B,S]
    cfg: DecoderConfig,
    *,
    kv_cache: Optional[dict] = None,    # {"k","v": [B,Smax,K,Dh], "len": int}
    attn_impl: str = "xla",
    prefill: bool = False,              # cache start is known to be 0
    lora: Optional[dict] = None,        # per-layer adapter view (index_layer)
):
    """Returns (out [B,S,D], new_kv_cache|None). The cache path writes the
    new K/V into ``kv_cache``'s tensors in place at ``len`` and returns them
    with the advanced length. ``lora``: each row's low-rank adapter delta
    adds onto the shared projections (rows with aidx = -1 add exact 0).
    Without a cache this is ``attention_out`` after ``attention_qkv``, the
    two halves ``block_outs`` remat checkpoints apart."""
    q, k, v = attention_qkv(p, x, positions, cfg, lora)
    if kv_cache is None:
        return attention_out(p, q, k, v, cfg, attn_impl=attn_impl,
                             lora=lora), None
    start = int(kv_cache["len"])
    ck, cv = kv_cache["k"], kv_cache["v"]
    s = x.shape[1]
    if start + s > ck.shape[1]:
        raise ValueError(f"cache write [{start}, {start + s}) past the "
                         f"cache length {ck.shape[1]}")
    ck[:, start:start + s] = k
    cv[:, start:start + s] = v
    new_cache = {"k": ck, "v": cv, "len": start + s}
    if attn_impl == "pallas" and prefill:
        # Prefill from an empty scratch cache: start is 0 and the cache
        # length equals the block, so the flash kernel applies directly.
        out = multi_head_attention(q, ck, cv, causal=True, q_offset=0,
                                   impl="pallas")
    else:
        # A cache offset that is not statically 0: the masked plain path.
        impl = "xla" if attn_impl == "pallas" else attn_impl
        out = multi_head_attention(q, ck, cv, causal=True, q_offset=start,
                                   impl=impl)
    return attention_proj(p, out, cfg, lora), new_cache


# -- MLP -----------------------------------------------------------------------

def init_mlp(gen: torch.Generator, cfg: DecoderConfig, dtype=None,
             post=_keep) -> dict:
    dt = dtype or cfg.weight_dtype
    d, m = cfg.hidden, cfg.mlp_dim
    return {
        "gate": post("gate", _init(gen, (d, m), dt)),
        "up": post("up", _init(gen, (d, m), dt)),
        "down": post("down", _init(gen, (m, d), dt, scale=m ** -0.5)),
    }


def mlp_block(p: dict, x: torch.Tensor, cfg: DecoderConfig) -> torch.Tensor:
    """``down(act(gate x) * up x)``; under a model axis ``gate``/``up``
    hold the rank's mlp columns and ``down``'s partial products are summed
    over the axis (JAX's ``tp_axis`` form)."""
    dt = cfg.activation_dtype
    tp = model_axis_of(cfg)
    if tp is not None:
        _check_cut(p["gate"].shape[-1], cfg.mlp_dim, cfg, "mlp")
        x = C.copy_to_model(x, tp)
    gate_pre = project(x, p["gate"], dt)
    up = project(x, p["up"], dt)
    if fused_kernels_on(cfg, x) and cfg.hidden_act in ("silu", "gelu"):
        h = fused_norm.swiglu_fused(gate_pre, up, act=cfg.hidden_act)
    else:
        h = fused_norm.act_ref(gate_pre, cfg.hidden_act) * up
    return C.reduce_from_model(project(h, p["down"], dt), tp)


# -- MoE -----------------------------------------------------------------------

def init_moe(gen: torch.Generator, cfg: DecoderConfig, dtype=None,
             post=_keep) -> dict:
    dt = dtype or cfg.weight_dtype
    d, m, e = cfg.hidden, cfg.mlp_dim, cfg.num_experts
    return {
        "router": post("router", _init(gen, (d, e), dt)),
        "gate": post("gate", _init(gen, (e, d, m), dt, scale=d ** -0.5)),
        "up": post("up", _init(gen, (e, d, m), dt, scale=d ** -0.5)),
        "down": post("down", _init(gen, (e, m, d), dt, scale=m ** -0.5)),
    }


def _no_parallel_axes(**axes) -> None:
    named = [k for k, v in axes.items() if v is not None]
    if named:
        raise NotImplementedError(
            f"MoE {', '.join(named)}: expert, sequence and tensor "
            "parallelism of MoE blocks arrive with a later multi-GPU slice "
            "(ROADMAP.md Queue 1 item 9)")


def moe_block(p: dict, x: torch.Tensor, cfg: DecoderConfig,
              expert_axis: Optional[str] = None,
              seq_axis: Optional[str] = None,
              valid_len=None, tp_axis: Optional[str] = None):
    """Top-k MoE (Mixtral semantics: softmax over the selected k logits),
    dispatching on ``cfg.moe_impl``: "dispatch" routes tokens into
    per-expert capacity buffers so only selected experts compute; "dense"
    is the drop-free every-expert oracle. Returns (out, aux_loss).

    ``valid_len`` (an int, or [B]): positions >= it are padding whose
    router choices claim no expert capacity (a prefill bucket's pads would
    otherwise displace real tokens' choices under choice-major priority).
    Dense ignores it."""
    _no_parallel_axes(expert_axis=expert_axis, seq_axis=seq_axis,
                      tp_axis=tp_axis)
    if cfg.moe_impl == "dispatch":
        return _moe_dispatch(p, x, cfg, valid_len=valid_len)
    if cfg.moe_impl != "dense":
        raise ValueError(f"unknown moe_impl {cfg.moe_impl!r}")
    return _moe_dense(p, x, cfg)


def _top_k(logits: torch.Tensor, k: int):
    """``jax.lax.top_k``: the k largest along the last axis, descending,
    ties to the lower index first (a stable descending sort;
    ``torch.topk`` promises no order among equal values)."""
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _moe_aux_loss(router_logits: torch.Tensor, onehot_sum: torch.Tensor,
                  cfg: DecoderConfig, valid=None) -> torch.Tensor:
    """Switch-style load-balancing loss: E * sum(frac_tokens * frac_probs).
    ``onehot_sum`` [B,S,E]: how many of the k choices hit each expert.
    ``valid`` [B,S] masks pad rows out of both fractions, which then divide
    by the valid-token count."""
    probs = torch.softmax(router_logits, dim=-1)                     # [B,S,E]
    if valid is not None:
        m = valid[..., None].to(probs.dtype)
        denom = torch.clamp(m.sum(), min=1.0)
        frac_tokens = (onehot_sum * m).sum(dim=(0, 1)) / denom
        frac_probs = (probs * m).sum(dim=(0, 1)) / denom
    else:
        frac_tokens = onehot_sum.mean(dim=(0, 1))
        frac_probs = probs.mean(dim=(0, 1))
    return cfg.num_experts * torch.sum(frac_tokens * frac_probs)


def moe_capacity(cfg: DecoderConfig, tokens: int) -> int:
    """Per-expert buffer size for a ``tokens``-token dispatch:
    ceil(capacity_factor * k * T / E), rounded up to a multiple of 8,
    capped at k*T (beyond that nothing can drop). It decides which
    (token, choice) pairs drop, so it is the JAX formula exactly."""
    e, k = cfg.num_experts, cfg.experts_per_token
    c = -(-int(cfg.capacity_factor * k * tokens) // e)
    c = -(-max(c, 1) // 8) * 8
    return min(c, k * tokens)


def _valid_rows(valid_len, b: int, s: int, device) -> torch.Tensor:
    """[B,S] bool: position < valid_len (an int, or a tensor of one or B
    lengths). An int compares as a scalar: no host→device copy."""
    pos = torch.arange(s, device=device)[None, :]
    if isinstance(valid_len, int):
        return (pos < valid_len).expand(b, s)
    vl = valid_len.reshape(-1)
    return pos < vl.expand(b)[:, None]


def _expert_ffn(buf: torch.Tensor, p: dict, cfg: DecoderConfig,
                dt: torch.dtype) -> torch.Tensor:
    """``act(buf @ gate) * up`` then ``@ down``, per expert: buf [E,N,D]
    (or [1,N,D], every expert on the same rows) → [E,N,D]
    (``"ecd,edm->ecm"`` and ``"ecm,emd->ecd"``). Tensor weights run three
    batched products. int8 experts (``QuantizedTensor``) dequantize one
    expert's matrix at a time, each freed once its product returns, so a
    forward never holds a dequantized ``[E, D, M]`` stack."""
    if isinstance(p["gate"], QuantizedTensor):
        out = torch.empty((p["gate"].shape[0],) + buf.shape[1:], dtype=dt,
                          device=buf.device)
        for i in range(out.shape[0]):
            xe = buf[0 if buf.shape[0] == 1 else i]
            gate = fused_norm.act_ref(xe @ p["gate"][i].dequant(dt),
                                      cfg.hidden_act)
            h = gate * (xe @ p["up"][i].dequant(dt))
            out[i] = h @ p["down"][i].dequant(dt)
        return out
    gate = fused_norm.act_ref(torch.matmul(buf, weight(p["gate"], dt)),
                              cfg.hidden_act)
    up = torch.matmul(buf, weight(p["up"], dt))
    return torch.matmul(gate * up, weight(p["down"], dt))


def dispatch_plan(router_logits: torch.Tensor, cfg: DecoderConfig, b: int,
                  s: int, valid_len=None) -> dict:
    """The dispatch path's routing for ``router_logits`` [T = B*S, E] fp32:

    - ``topk_w`` [T,k]: the softmax over each token's k best logits;
    - ``rows`` [kT]: each (choice-major) pair's slot in the [E*C] buffers,
      ``E*C`` for a dropped pair;
    - ``row_of_slot`` [E*C]: each slot's token, ``T`` for an empty slot;
    - ``claims`` [kT,E] int: the one-hot choices that claimed capacity;
    - ``valid`` [B,S] bool or None; ``capacity`` C.

    Priority is choice-major: every token's first choice claims capacity
    before any token's second choice. Pairs past capacity, and every pair
    of a row at or past ``valid_len``, are dropped."""
    t = b * s
    e, k = cfg.num_experts, cfg.experts_per_token
    dev = router_logits.device
    topk_logits, topk_idx = _top_k(router_logits, k)                 # [T,k]
    c = moe_capacity(cfg, t)
    # Choice-major flattening: row r = (choice r // T) of token (r % T).
    flat_e = topk_idx.T.reshape(-1)                                  # [kT]
    oh = torch.nn.functional.one_hot(flat_e, e)                      # [kT,E]
    valid_flat, valid_bs = None, None
    if valid_len is not None:
        # Padding rows claim no capacity (zeroed before the cumsum) and
        # are dropped outright.
        valid_bs = _valid_rows(valid_len, b, s, dev)                 # [B,S]
        valid_flat = valid_bs.reshape(t).repeat(k)
        oh = oh * valid_flat[:, None]
    pos = torch.cumsum(oh, dim=0) - 1
    pos_in_e = torch.gather(pos, 1, flat_e[:, None])[:, 0]           # [kT]
    keep = pos_in_e < c
    if valid_flat is not None:
        keep = keep & valid_flat
    rows = torch.where(keep, flat_e * c + pos_in_e,
                       torch.full_like(flat_e, e * c))
    tok_of = torch.arange(t, device=dev).repeat(k)                   # [kT]
    row_of_slot = torch.full((e * c + 1,), t, dtype=torch.int64, device=dev)
    row_of_slot.index_put_((rows,), tok_of)     # kept slots are unique
    return {"topk_w": torch.softmax(topk_logits, dim=-1), "rows": rows,
            "row_of_slot": row_of_slot[:e * c], "claims": oh,
            "valid": valid_bs, "capacity": c}


def _moe_dispatch(p: dict, x: torch.Tensor, cfg: DecoderConfig,
                  valid_len=None):
    """Capacity-factor top-k dispatch into static [E, C] buffers
    (``dispatch_plan``). A dropped pair contributes nothing, and the
    remaining choices are not renormalized. Capacity is per dispatch
    batch, so co-batched rows compete for it (the serving engine prefills
    MoE one request at a time).

    The buffers fill with one row gather over the plan's slot → token map
    (an empty slot reads the zero row past the tokens), and the combine
    gathers each pair's expert row (a dropped pair reads zero)."""
    dt = cfg.activation_dtype
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    t = b * s
    xf = x.reshape(t, d)
    router_logits = (xf @ weight(p["router"], dt)).float()           # [T,E]
    plan = dispatch_plan(router_logits, cfg, b, s, valid_len)
    c = plan["capacity"]
    zero = torch.zeros((1, d), dtype=x.dtype, device=x.device)
    buf = torch.cat([xf, zero]).index_select(
        0, plan["row_of_slot"]).reshape(e, c, d)
    y = _expert_ffn(buf, p, cfg, dt).reshape(e * c, d)
    back = torch.cat([y, zero.to(y.dtype)]).index_select(
        0, plan["rows"])                                             # [kT,D]
    w_flat = plan["topk_w"].T.reshape(-1, 1).to(dt)
    out = (back * w_flat).reshape(k, t, d).sum(0).reshape(b, s, d)
    aux = _moe_aux_loss(
        router_logits.reshape(b, s, e),
        plan["claims"].float().reshape(k, t, e).sum(0).reshape(b, s, e),
        cfg, valid=plan["valid"])
    return out, aux


def _moe_dense(p: dict, x: torch.Tensor, cfg: DecoderConfig):
    """Every expert computes every token and a one-hot combine weights the
    results: drop-free, E/k of the dispatch path's expert FLOPs — the
    dispatch path's correctness oracle, and the serving decode's path."""
    dt = cfg.activation_dtype
    b, s, d = x.shape
    e = cfg.num_experts
    router_logits = (x @ weight(p["router"], dt)).float()            # [B,S,E]
    topk_logits, topk_idx = _top_k(router_logits,
                                   cfg.experts_per_token)            # [B,S,k]
    topk_w = torch.softmax(topk_logits, dim=-1)
    onehot = torch.nn.functional.one_hot(topk_idx, e).float()        # [B,S,k,E]
    combine = torch.einsum("bske,bsk->bse", onehot, topk_w)          # [B,S,E]
    expert_out = _expert_ffn(x.reshape(1, b * s, d), p, cfg, dt)     # [E,T,D]
    out = torch.einsum("etd,te->td", expert_out,
                       combine.reshape(b * s, e).to(dt)).reshape(b, s, d)
    aux = _moe_aux_loss(router_logits, onehot.sum(dim=2), cfg)
    return out, aux


# -- Embedding -----------------------------------------------------------------

def embed_scale_value(cfg: DecoderConfig) -> float:
    """The gemma embedding scale sqrt(hidden), rounded to the activation
    dtype first (as the JAX package does), as a host float: multiplying by
    it launches no host→device copy."""
    return float(torch.tensor(cfg.hidden ** 0.5, dtype=cfg.activation_dtype))


def embed(table, tokens: torch.Tensor, cfg: DecoderConfig) -> torch.Tensor:
    """The rows of ``tokens`` in the embedding ``table``, in the activation
    dtype. Under a model axis ``table`` holds the rank's vocab rows: a
    token outside them reads zero and the ranks' rows are summed over the
    axis (exactly one rank adds a nonzero row, so the sum is the lookup's
    bits)."""
    dt = cfg.activation_dtype
    tp = model_axis_of(cfg)
    if tp is None:
        return table[tokens].to(dt)
    rows = table.shape[0]
    _check_cut(rows, cfg.vocab_size, cfg, "vocab")
    local = tokens - tp.rank * rows
    hit = (local >= 0) & (local < rows)
    x = table[local.clamp(0, rows - 1)].to(dt) * hit[..., None].to(dt)
    return C.reduce_from_model(x, tp)


def init_embedding(gen: torch.Generator, cfg: DecoderConfig,
                   dtype=None) -> torch.Tensor:
    return _init(gen, (cfg.vocab_size, cfg.hidden), dtype or cfg.weight_dtype,
                 scale=1.0)
