"""Decoder building blocks — RMSNorm, RoPE, GQA attention, (Swi/Ge)GLU MLP,
embedding — as plain functions over param dicts (port of
``kubeflow_tpu/models/layers.py``, dense path).

Params keep the JAX package's keys and layouts (``wq [D,H,Dh]``,
``wo [H,Dh,D]``, ``gate/up [D,M]``, ``down [M,D]``); projections are
matmuls over reshaped views of them. Compute follows the same dtype
policy: weights cast to the activation dtype at use, norms/softmax/RoPE in
fp32. Multi-tenant LoRA deltas (``lora_contrib``) add onto the attention
projections; sequence-parallel attention arrives in a later slice (it
raises here); MoE configs are refused by the decoder.
"""

from __future__ import annotations

from typing import Optional

import torch

from kubeflow_tpu_torch.models.config import DecoderConfig
from kubeflow_tpu_torch.ops import fused_norm
from kubeflow_tpu_torch.ops.attention import multi_head_attention


def _init(gen: torch.Generator, shape, dtype: torch.dtype,
          scale: Optional[float] = None) -> torch.Tensor:
    """Truncated-normal init in [-2, 2] with 1/sqrt(fan_in) default scale,
    drawn in fp32 on ``gen``'s device and cast to ``dtype``."""
    fan_in = shape[0] if len(shape) > 1 else shape[-1]
    scale = scale if scale is not None else fan_in ** -0.5
    t = torch.empty(shape, dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (t * scale).to(dtype)


# -- Fused-kernel resolution ---------------------------------------------------

def fused_kernels_on(cfg: DecoderConfig, x: torch.Tensor) -> bool:
    """Resolve ``cfg.fused_kernels`` ("auto"|"on"|"off") for tensor ``x``:
    "auto" routes CUDA tensors through the hand-written kernels and keeps
    CPU tensors on the plain ops. The kernels carry their own backward
    (``autograd.Function``s), so serving and training take the same path."""
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


# -- Attention block -----------------------------------------------------------

def init_attention(gen: torch.Generator, cfg: DecoderConfig, dtype=None) -> dict:
    dt = dtype or cfg.weight_dtype
    d = cfg.hidden
    return {
        "wq": _init(gen, (d, cfg.n_heads, cfg.head_dim), dt),
        "wk": _init(gen, (d, cfg.n_kv_heads, cfg.head_dim), dt),
        "wv": _init(gen, (d, cfg.n_kv_heads, cfg.head_dim), dt),
        "wo": _init(gen, (cfg.n_heads, cfg.head_dim, d), dt,
                    scale=(cfg.n_heads * cfg.head_dim) ** -0.5),
    }


def project(x: torch.Tensor, w: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """``einsum("bsd,dhk->bshk")`` (or ``"bsd,dm->bsm"``) as one matmul over
    the weight's [D, rest] view."""
    b, s, d = x.shape
    out = x @ w.to(dt).reshape(d, -1)
    return out.reshape(b, s, *w.shape[1:])


def out_project(attn: torch.Tensor, wo: torch.Tensor,
                dt: torch.dtype) -> torch.Tensor:
    """``einsum("bshk,hkd->bsd")``."""
    b, s = attn.shape[:2]
    return attn.reshape(b, s, -1) @ wo.to(dt).reshape(-1, wo.shape[-1])


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
    adds onto the shared projections (rows with aidx = -1 add exact 0)."""
    dt = cfg.activation_dtype
    q = project(x, p["wq"], dt)
    k = project(x, p["wk"], dt)
    v = project(x, p["wv"], dt)
    if lora is not None:
        q = apply_lora_layer(lora, "wq", x, q)
        k = apply_lora_layer(lora, "wk", x, k)
        v = apply_lora_layer(lora, "wv", x, v)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)

    new_cache = None
    if kv_cache is not None:
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
            out = multi_head_attention(q, ck, cv, causal=True,
                                       q_offset=start, impl=impl)
    elif attn_impl in ("ring", "ring_flash", "ulysses", "ring_local",
                       "ring_flash_local", "ulysses_local"):
        raise NotImplementedError(
            f"attn_impl={attn_impl!r}: sequence-parallel attention arrives "
            "with the multi-GPU slice")
    else:
        out = multi_head_attention(q, k, v, causal=True, impl=attn_impl)
    proj = out_project(out, p["wo"], dt)
    if lora is not None:
        b, s = out.shape[0], out.shape[1]
        proj = apply_lora_layer(lora, "wo", out.reshape(b, s, -1), proj)
    return proj, new_cache


# -- MLP -----------------------------------------------------------------------

def init_mlp(gen: torch.Generator, cfg: DecoderConfig, dtype=None) -> dict:
    dt = dtype or cfg.weight_dtype
    d, m = cfg.hidden, cfg.mlp_dim
    return {
        "gate": _init(gen, (d, m), dt),
        "up": _init(gen, (d, m), dt),
        "down": _init(gen, (m, d), dt, scale=m ** -0.5),
    }


def mlp_block(p: dict, x: torch.Tensor, cfg: DecoderConfig) -> torch.Tensor:
    dt = cfg.activation_dtype
    gate_pre = project(x, p["gate"], dt)
    up = project(x, p["up"], dt)
    if fused_kernels_on(cfg, x) and cfg.hidden_act in ("silu", "gelu"):
        h = fused_norm.swiglu_fused(gate_pre, up, act=cfg.hidden_act)
    else:
        h = fused_norm.act_ref(gate_pre, cfg.hidden_act) * up
    return project(h, p["down"], dt)


# -- Embedding -----------------------------------------------------------------

def embed_scale_value(cfg: DecoderConfig) -> float:
    """The gemma embedding scale sqrt(hidden), rounded to the activation
    dtype first (as the JAX package does), as a host float: multiplying by
    it launches no host→device copy."""
    return float(torch.tensor(cfg.hidden ** 0.5, dtype=cfg.activation_dtype))


def init_embedding(gen: torch.Generator, cfg: DecoderConfig,
                   dtype=None) -> torch.Tensor:
    return _init(gen, (cfg.vocab_size, cfg.hidden), dtype or cfg.weight_dtype,
                 scale=1.0)
