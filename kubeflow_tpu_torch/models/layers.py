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
(``embed``). Heads, kv heads, mlp columns, the vocabulary and experts
that do not divide over their axis are whole on every rank, as JAX
replicates them, and each rank computes its part of them (``part``,
``head_owners``): the kv heads its own q heads read (``rank_kv``). The
MoE block runs under the expert, batch, sequence and model axes as JAX's
GSPMD block does on the global batch (``moe_block``, ``MoEAxes``): local
experts and columns, the dispatch plan and the balance loss over the
global batch, one sum of the partial outputs over ``expert`` ×
``model``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch
import torch.distributed as dist

from kubeflow_tpu_torch.models.config import DecoderConfig, model_axis_of
from kubeflow_tpu_torch.ops import fused_norm
from kubeflow_tpu_torch.parallel import collectives as C
from kubeflow_tpu_torch.parallel.collectives import axis_part, part
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
#
# A dim that JAX splits over ``model`` (or ``expert``) but that does not
# divide over the axis is replicated there, as JAX's ``shard_params``
# replicates it: every rank holds the whole leaf. The ranks still share its
# work: each computes its own part of it (``part``), so the row-parallel
# sums and the vocab-parallel combine stay as they are, and the leaf's
# gradient, nonzero on each rank in its part alone, is summed over the axis
# (``sharding.Placement.partial``).

def _narrow(leaf, dim: int, start: int, length: int):
    if isinstance(leaf, QuantizedTensor):
        d = dim % leaf.ndim
        scale = leaf.scale
        if scale.shape[d] > 1:
            scale = scale.narrow(d, start, length)
        return QuantizedTensor(leaf.q.narrow(d, start, length), scale)
    return leaf.narrow(dim, start, length)


def rank_part(leaf, dim: int, whole: int, lo: int, hi: int, what: str):
    """The part ``[lo, hi)`` of ``dim`` of a leaf that is that part already
    (the rank's cut of a dim that divides) or whole (a dim replicated
    because it does not divide, or a leaf never cut)."""
    n = leaf.shape[dim]
    if n == hi - lo:
        return leaf
    if n != whole:
        raise ValueError(f"{what}: a leaf of {n} on a rank whose part is "
                         f"[{lo}, {hi}) of {whole}")
    return _narrow(leaf, dim, lo, hi - lo)


def rank_part_of(leaf, dim: int, whole: int, tp: Optional[C.ModelAxis],
                 what: str, span: Optional[tuple[int, int]] = None):
    """``rank_part`` of this rank's ``span`` of ``whole`` over the model
    axis ``tp`` (its ``axis_part`` by default); the leaf as it is without
    one. Every leaf that may be cut over ``model`` is read through here."""
    if tp is None:
        return leaf
    return rank_part(leaf, dim, whole, *(span or axis_part(whole, tp)), what)


def model_part(whole: int, cfg: DecoderConfig) -> tuple[int, int]:
    """This rank's part of ``whole`` columns (mlp, vocabulary) over the
    config's model axis; all of them without one."""
    return axis_part(whole, model_axis_of(cfg))


def rank_cols(leaf, dim: int, whole: int, cfg: DecoderConfig, what: str):
    """``rank_part_of`` under the config's model axis."""
    return rank_part_of(leaf, dim, whole, model_axis_of(cfg), what)


def head_owners(cfg: DecoderConfig) -> list[tuple[int, int]]:
    """``[start, stop)`` of the q heads each rank of the model axis
    computes, in rank order. Heads that divide over the axis are the even
    split of ``wq``. Heads that do not are whole on every rank, and the
    ranks share them along GQA groups: whole groups a rank where there are
    at least as many groups as ranks, else each group's heads shared by
    the ranks that fall to it, so that a rank's q heads read whole kv
    heads in order."""
    tp = model_axis_of(cfg)
    h, k = cfg.n_heads, cfg.n_kv_heads
    if tp is None:
        return [(0, h)]
    n, g = tp.size, h // k
    if h % n == 0:
        return [part(h, r, n) for r in range(n)]
    if k >= n:
        return [(g * a, g * b) for a, b in (part(k, r, n) for r in range(n))]
    out = []
    for r in range(n):
        grp = r * k // n
        mates = [s for s in range(n) if s * k // n == grp]
        a, b = part(g, mates.index(r), len(mates))
        out.append((grp * g + a, grp * g + b))
    return out


def head_range(cfg: DecoderConfig) -> tuple[int, int]:
    """This rank's ``head_owners`` entry."""
    tp = model_axis_of(cfg)
    return head_owners(cfg)[0 if tp is None else tp.rank]


def kv_head_owners(cfg: DecoderConfig) -> list[tuple[int, ...]]:
    """The kv heads each rank's cache holds, in rank order: the global
    indices its q heads read (``head_owners``). A rank whose q heads fill
    their groups in order holds each kv head once (its split of them where
    they divide); a rank whose q heads split a group unevenly (``wq``
    split, kv heads whole) holds one kv head per q head, repeated where
    its q heads share one, and attends as plain multi-head attention."""
    g = cfg.n_heads // cfg.n_kv_heads
    out = []
    for a, b in head_owners(cfg):
        owners = [q // g for q in range(a, b)]
        distinct = sorted(set(owners))
        per = len(owners) // max(len(distinct), 1)
        if owners == [kv for kv in distinct for _ in range(per)]:
            out.append(tuple(distinct))
        else:
            out.append(tuple(owners))
    return out


def local_kv_heads(cfg: DecoderConfig) -> tuple[int, ...]:
    """This rank's ``kv_head_owners`` entry (every kv head without a model
    axis)."""
    tp = model_axis_of(cfg)
    if tp is None:
        return tuple(range(cfg.n_kv_heads))
    return kv_head_owners(cfg)[tp.rank]


def take_kv_heads(t, dim: int, cfg: DecoderConfig):
    """This rank's kv heads (``local_kv_heads``) of ``t``, whose ``dim``
    holds every kv head: a view where they are contiguous and ascending."""
    heads = local_kv_heads(cfg)
    if heads == tuple(range(heads[0], heads[0] + len(heads))):
        return _narrow(t, dim, heads[0], len(heads))
    idx = torch.tensor(heads, dtype=torch.long, device=t.q.device if
                       isinstance(t, QuantizedTensor) else t.device)
    if isinstance(t, QuantizedTensor):
        d = dim % t.ndim
        scale = t.scale.index_select(d, idx) if t.scale.shape[d] > 1 \
            else t.scale
        return QuantizedTensor(t.q.index_select(d, idx), scale)
    return t.index_select(dim, idx)


def rank_q(w, cfg: DecoderConfig, dim: int = 1):
    """This rank's q heads of ``wq`` (``dim`` 1) or ``wo`` (``dim`` 0); the
    leaf as it is without a model axis."""
    return rank_part_of(w, dim, cfg.n_heads, model_axis_of(cfg), "heads",
                        head_range(cfg))


def rank_kv(w, cfg: DecoderConfig):
    """The kv heads this rank reads of a ``[D, K, Dh]`` leaf: the leaf as
    it is when it is the rank's split, its heads when it is whole."""
    tp = model_axis_of(cfg)
    if tp is None:
        return w
    k = cfg.n_kv_heads
    if k % tp.size == 0 and w.shape[1] == k // tp.size:
        return w
    if w.shape[1] != k:
        raise ValueError(f"kv heads: a leaf of {w.shape[1]} on a rank of "
                         f"model = {tp.size} (whole {k})")
    return take_kv_heads(w, 1, cfg)


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
    x = C.copy_to_model(x, model_axis_of(cfg))
    q = project(x, rank_q(p["wq"], cfg), dt)
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
    proj = out_project(out, rank_q(p["wo"], cfg, 0), cfg.activation_dtype)
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
    x = C.copy_to_model(x, tp)
    m = cfg.mlp_dim
    gate_pre = project(x, rank_cols(p["gate"], -1, m, cfg, "mlp"), dt)
    up = project(x, rank_cols(p["up"], -1, m, cfg, "mlp"), dt)
    if fused_kernels_on(cfg, x) and cfg.hidden_act in ("silu", "gelu"):
        h = fused_norm.swiglu_fused(gate_pre, up, act=cfg.hidden_act)
    else:
        h = fused_norm.act_ref(gate_pre, cfg.hidden_act) * up
    return C.reduce_from_model(
        project(h, rank_cols(p["down"], 0, m, cfg, "mlp"), dt), tp)


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


@dataclasses.dataclass(frozen=True)
class MoEAxes:
    """Where one MoE block's work is split (``moe_axes``):

    - ``group``: the ``expert`` × ``model`` ranks, which hold the same
      tokens. Each computes its experts' part of the output (under
      ``model``, with its columns of each expert's ``gate``/``up`` and
      rows of ``down``), and the parts are summed over the group in one
      reduction;
    - ``expert`` / ``experts``: this rank's index over ``expert`` and the
      degree. It holds experts ``[expert · E_l, (expert + 1) · E_l)``,
      E_l = E / experts;
    - ``tokens``: the batch and ``seq`` ranks, which hold the rest of the
      global batch (JAX's GSPMD block sees that batch whole). ``places``
      gives each of them, in the group's order, its (batch index, seq
      index); ``place`` is this rank's and ``shape`` the two degrees.
      None inside a pipeline stage (JAX's stage ``shard_map``): the plan
      and the balance loss are then over the stage's microbatch of this
      rank's rows and positions;
    - ``seq``: inside a pipeline stage, the ``seq`` group whose ranks
      hold the other parts of the microbatch's sequences: the balance
      loss's fractions are their mean over it (JAX's ``seq_axis``
      pmean)."""

    group: Any = None
    expert: int = 0
    experts: int = 1
    tokens: Any = None
    places: tuple = ((0, 0),)
    place: tuple = (0, 0)
    shape: tuple = (1, 1)
    seq: Any = None


def moe_axes(cfg: DecoderConfig, mesh=None) -> Optional[MoEAxes]:
    """The split of an MoE block over ``mesh``'s expert, model, batch and
    seq axes (training: the groups are made on first use, by every rank in
    one order, and kept on the mesh), else over the config's model axis
    (a tensor-parallel engine: one request's tokens on every rank); None
    on one device."""
    tp = model_axis_of(cfg)
    if mesh is None:
        return None if tp is None else MoEAxes(group=tp.group)
    cache = mesh.__dict__.setdefault("_kftpu_moe_axes", [])
    if not cache:
        cache.append(_mesh_moe_axes(mesh))
    return cache[0]


def _mesh_moe_axes(mesh) -> Optional[MoEAxes]:
    from kubeflow_tpu_torch.parallel.fsdp import BATCH_AXES, TOKEN_AXES
    from kubeflow_tpu_torch.parallel.sharding import (
        EP_AXIS, TP_AXIS, mesh_coords, mesh_shape,
    )

    sizes = mesh_shape(mesh)
    group = C.axis_group(mesh, (EP_AXIS, TP_AXIS))
    if sizes.get("pipeline", 1) > 1:
        seq = C.axis_group(mesh, ("seq",))
        if group is None and seq is None:
            return None
        return MoEAxes(group, mesh.get_local_rank(EP_AXIS), sizes[EP_AXIS],
                       seq=seq)
    tokens = C.axis_group(mesh, TOKEN_AXES)
    if group is None and tokens is None:
        return None

    def place(coords: dict) -> tuple[int, int]:
        bi = 0
        for a in BATCH_AXES:
            bi = bi * sizes[a] + coords[a]
        return bi, coords["seq"]

    places = [(0, 0)]
    if tokens is not None:
        places = []
        for r in dist.get_process_group_ranks(tokens):
            at = (mesh.mesh == r).nonzero()[0].tolist()
            places.append(place(dict(zip(mesh.mesh_dim_names, at))))
    dp = math.prod(sizes[a] for a in BATCH_AXES)
    return MoEAxes(group, mesh.get_local_rank(EP_AXIS), sizes[EP_AXIS],
                   tokens, tuple(places), place(mesh_coords(mesh)),
                   (dp, sizes["seq"]))


def _expert_range(cfg: DecoderConfig,
                  axes: Optional[MoEAxes]) -> tuple[int, int]:
    """(first, count) of the experts this rank computes: its split of them
    over ``expert``, or its part where they do not divide (``part``)."""
    if axes is None:
        return 0, cfg.num_experts
    lo, hi = part(cfg.num_experts, axes.expert, axes.experts)
    return lo, hi - lo


def _local_experts(p: dict, cfg: DecoderConfig,
                   axes: Optional[MoEAxes]) -> tuple[dict, tuple[int, int]]:
    """The block's leaves with ``gate``/``up``/``down`` at this rank's
    experts and, under ``model``, their columns (each leaf as it is where
    it is the rank's cut, its part where it is whole), and
    ``_expert_range``."""
    first, count = _expert_range(cfg, axes)
    e, m = cfg.num_experts, cfg.mlp_dim
    out = dict(p)
    for name, cols in (("gate", 2), ("up", 2), ("down", 1)):
        w = rank_part(p[name], 0, e, first, first + count, "experts")
        out[name] = rank_cols(w, cols, m, cfg, "expert_mlp")
    return out, (first, count)


def moe_block(p: dict, x: torch.Tensor, cfg: DecoderConfig,
              valid_len=None, mesh=None):
    """Top-k MoE (Mixtral semantics: softmax over the selected k logits),
    dispatching on ``cfg.moe_impl``: "dispatch" routes tokens into
    per-expert capacity buffers so only selected experts compute; "dense"
    is the drop-free every-expert oracle. Returns (out, aux_loss).

    ``valid_len`` (an int, or [B]): positions >= it are padding whose
    router choices claim no expert capacity (a prefill bucket's pads would
    otherwise displace real tokens' choices under choice-major priority).
    Dense ignores it.

    Under ``mesh`` (training) or a config's model axis (``moe_axes``) the
    block runs as JAX's GSPMD block does on the global batch: each rank
    computes its local experts (and columns) for its tokens, the router
    whole; the dispatch plan's capacity and priority span the global batch
    (``dispatch_plan``), and so does the balance loss (``_moe_aux_loss``,
    this rank's part of it). The combined partial outputs are summed over
    the ``expert`` × ``model`` ranks in one reduction (``collectives.
    reduce_from``); the experts' input and the combine weights, whose
    gradient on each rank sees only its own experts, pass
    ``collectives.copy_to``, whose backward sums over the same ranks."""
    axes = moe_axes(cfg, mesh)
    if cfg.moe_impl not in ("dispatch", "dense"):
        raise ValueError(f"unknown moe_impl {cfg.moe_impl!r}")
    p, experts = _local_experts(p, cfg, axes)
    logits, topk_w, topk_idx = moe_route(p, x, cfg)
    group = None if axes is None else axes.group
    xin, w = C.copy_to(x, group), C.copy_to(topk_w, group)
    if cfg.moe_impl == "dispatch":
        plan = dispatch_plan(topk_idx, cfg, valid_len, axes)
        out = expert_dispatch(p, xin, w, plan, cfg)
        b, s, e = logits.shape
        onehot_sum = plan["claims"].float().reshape(
            cfg.experts_per_token, b * s, e).sum(0).reshape(b, s, e)
        valid = plan["valid"]
    else:
        onehot = torch.nn.functional.one_hot(topk_idx,
                                             cfg.num_experts).float()
        combine = torch.einsum("bske,bsk->bse", onehot, w)           # [B,S,E]
        out = expert_dense(p, xin, combine, cfg, experts)
        onehot_sum, valid = onehot.sum(dim=2), None
    out = C.reduce_from(out, group)
    aux = _moe_aux_loss(logits, onehot_sum, cfg, valid=valid, axes=axes)
    return out, aux


def _top_k(logits: torch.Tensor, k: int):
    """``jax.lax.top_k``: the k largest along the last axis, descending,
    ties to the lower index first (a stable descending sort;
    ``torch.topk`` promises no order among equal values)."""
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_route(p: dict, x: torch.Tensor, cfg: DecoderConfig):
    """The router on ``x`` [B,S,D]: ``(router_logits [B,S,E] fp32, topk_w
    [B,S,k], topk_idx [B,S,k])``, the weights the softmax over each
    token's k best logits."""
    logits = (x @ weight(p["router"], cfg.activation_dtype)).float()
    topk_logits, topk_idx = _top_k(logits, cfg.experts_per_token)
    return logits, torch.softmax(topk_logits, dim=-1), topk_idx


def _moe_aux_loss(router_logits: torch.Tensor, onehot_sum: torch.Tensor,
                  cfg: DecoderConfig, valid=None,
                  axes: Optional[MoEAxes] = None) -> torch.Tensor:
    """Switch-style load-balancing loss: E * sum(frac_tokens * frac_probs).
    ``onehot_sum`` [B,S,E]: how many of the k choices hit each expert.
    ``valid`` [B,S] masks pad rows out of both fractions, which then divide
    by the valid-token count.

    ``axes`` whose ``tokens`` group holds the rest of the batch (no pad
    rows there): the fractions are the global batch's. The claim counts
    are summed over the token ranks without a gradient; ``frac_probs``
    takes this rank's tokens alone over the global count, so the result
    is this rank's part: the parts over the token ranks sum to the global
    loss, and so do their gradients. The ranks of one ``expert`` ×
    ``model`` group compute the same part."""
    probs = torch.softmax(router_logits, dim=-1)                     # [B,S,E]
    if axes is not None and axes.seq is not None:
        # A pipeline stage's seq part: the fractions' mean over the seq
        # ranks; each rank's gradient is its own part's.
        n = dist.get_world_size(axes.seq)
        frac_tokens = onehot_sum.mean(dim=(0, 1)).detach()
        dist.all_reduce(frac_tokens, group=axes.seq)
        mine = probs.mean(dim=(0, 1))
        total = mine.detach().clone()
        dist.all_reduce(total, group=axes.seq)
        frac_tokens = frac_tokens / n
        frac_probs = (mine + (total - mine.detach())) / n
    elif axes is not None and axes.tokens is not None:
        with torch.no_grad():
            counts = onehot_sum.sum(dim=(0, 1))
            dist.all_reduce(counts, group=axes.tokens)
        t = probs.shape[0] * probs.shape[1] * len(axes.places)
        frac_tokens = counts / t
        frac_probs = probs.sum(dim=(0, 1)) / t
    elif valid is not None:
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


def global_choices(topk_idx: torch.Tensor, axes: Optional[MoEAxes]):
    """Every token's k expert ids over the global batch in JAX's (b, s)
    order, ``[T_g, k]``, and the global indices of this rank's tokens
    (``[T]``; None when the rank holds the whole batch). The ids are
    all-gathered over the token ranks (a few KB); a batch rank's rows are
    contiguous, a ``seq`` rank's positions its part of every row."""
    b, s, k = topk_idx.shape
    if axes is None or axes.tokens is None:
        return topk_idx.reshape(b * s, k), None
    dev = topk_idx.device
    parts = topk_idx.new_empty((len(axes.places) * b, s, k))
    dist.all_gather_into_tensor(parts, topk_idx.contiguous(),
                                group=axes.tokens)
    dp, sp = axes.shape
    ids = topk_idx.new_empty((dp * b, sp * s, k))
    for g, (bi, si) in enumerate(axes.places):
        ids[bi * b:(bi + 1) * b, si * s:(si + 1) * s] = parts[g * b:
                                                              (g + 1) * b]
    bi, si = axes.place
    rows = torch.arange(bi * b, (bi + 1) * b, device=dev)
    cols = torch.arange(si * s, (si + 1) * s, device=dev)
    mine = (rows[:, None] * (sp * s) + cols[None, :]).reshape(-1)
    return ids.reshape(-1, k), mine


def dispatch_plan(topk_idx: torch.Tensor, cfg: DecoderConfig,
                  valid_len=None, axes: Optional[MoEAxes] = None,
                  choices=None) -> dict:
    """The dispatch path's routing of this rank's tokens, whose choices
    are ``topk_idx`` [B,S,k], over the global batch (``global_choices``,
    or ``choices``: the global ids and this rank's indices among them):

    - ``rows`` [kT]: each (choice-major) pair's slot in this rank's
      [E_l*C] buffers, ``E_l*C`` for a pair dropped or routed to another
      rank's expert;
    - ``row_of_slot`` [E_l*C]: each slot's token, ``T`` for an empty slot;
    - ``keep`` [kT] bool: the pairs the plan keeps, whichever rank's
      expert they go to;
    - ``claims`` [kT,E] int: the one-hot choices that claimed capacity;
    - ``valid`` [B,S] bool or None; ``capacity`` C.

    Priority is choice-major over the global batch: every token's first
    choice claims capacity before any token's second choice, and C is the
    global token count's (``moe_capacity``). Pairs past capacity, and
    every pair of a row at or past ``valid_len`` (one process's batch),
    are dropped."""
    b, s, k = topk_idx.shape
    t = b * s
    e = cfg.num_experts
    dev = topk_idx.device
    off, el = _expert_range(cfg, axes)
    ids, mine = choices or global_choices(topk_idx, axes)
    tg = ids.shape[0]
    c = moe_capacity(cfg, tg)
    # Choice-major flattening: row r = (choice r // T) of token (r % T).
    flat_g = ids.T.reshape(-1)                                       # [kTg]
    oh = torch.nn.functional.one_hot(flat_g, e)                      # [kTg,E]
    valid_flat, valid_bs = None, None
    if valid_len is not None:
        if mine is not None:
            raise ValueError("valid_len masks one process's batch")
        # Padding rows claim no capacity (zeroed before the cumsum) and
        # are dropped outright.
        valid_bs = _valid_rows(valid_len, b, s, dev)                 # [B,S]
        valid_flat = valid_bs.reshape(t).repeat(k)
        oh = oh * valid_flat[:, None]
    pos = torch.cumsum(oh, dim=0) - 1
    pos_in_e = torch.gather(pos, 1, flat_g[:, None])[:, 0]           # [kTg]
    flat_e = flat_g
    if mine is not None:
        flat_e = topk_idx.reshape(t, k).T.reshape(-1)                # [kT]
        # This rank's pairs among the global ones, choice-major.
        sel = (torch.arange(k, device=dev)[:, None] * tg
               + mine[None, :]).reshape(-1)
        pos_in_e, oh = pos_in_e[sel], oh[sel]
    keep = pos_in_e < c
    if valid_flat is not None:
        keep = keep & valid_flat
    ours = keep
    if el != e:
        ours = keep & (flat_e >= off) & (flat_e < off + el)
    rows = torch.where(ours, (flat_e - off if off else flat_e) * c
                       + pos_in_e,
                       torch.full_like(flat_e, el * c))
    tok_of = torch.arange(t, device=dev).repeat(k)                   # [kT]
    row_of_slot = torch.full((el * c + 1,), t, dtype=torch.int64, device=dev)
    row_of_slot.index_put_((rows,), tok_of)     # kept slots are unique
    return {"rows": rows, "row_of_slot": row_of_slot[:el * c],
            "keep": keep, "claims": oh, "valid": valid_bs, "capacity": c}


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


def expert_dispatch(p: dict, x: torch.Tensor, topk_w: torch.Tensor,
                    plan: dict, cfg: DecoderConfig) -> torch.Tensor:
    """Capacity-factor top-k dispatch of ``x`` [B,S,D] into static [E_l, C]
    buffers of this rank's experts (``dispatch_plan``): their weighted
    outputs combined per token, [B,S,D]. A dropped pair contributes
    nothing, and the remaining choices are not renormalized. Capacity is
    per dispatch batch, so co-batched rows compete for it (the serving
    engine prefills MoE one request at a time).

    The buffers fill with one row gather over the plan's slot → token map
    (an empty slot reads the zero row past the tokens), and the combine
    gathers each pair's expert row (a dropped pair reads zero)."""
    dt = cfg.activation_dtype
    b, s, d = x.shape
    k = cfg.experts_per_token
    t = b * s
    c = plan["capacity"]
    el = plan["row_of_slot"].shape[0] // c
    xf = x.reshape(t, d)
    zero = torch.zeros((1, d), dtype=x.dtype, device=x.device)
    buf = torch.cat([xf, zero]).index_select(
        0, plan["row_of_slot"]).reshape(el, c, d)
    y = _expert_ffn(buf, p, cfg, dt).reshape(el * c, d)
    back = torch.cat([y, zero.to(y.dtype)]).index_select(
        0, plan["rows"])                                             # [kT,D]
    w_flat = topk_w.reshape(t, k).T.reshape(-1, 1).to(dt)
    return (back * w_flat).reshape(k, t, d).sum(0).reshape(b, s, d)


def expert_dense(p: dict, x: torch.Tensor, combine: torch.Tensor,
                 cfg: DecoderConfig, experts: tuple[int, int]) -> torch.Tensor:
    """Every local expert (``experts``: first, count) computes every token
    and the combine weights [B,S,E] (each token's top-k weights at its
    experts, 0 elsewhere), sliced at the rank's experts, weight the
    results: drop-free, E/k of the dispatch path's expert FLOPs — the
    dispatch path's correctness oracle, and the serving decode's path."""
    dt = cfg.activation_dtype
    b, s, d = x.shape
    off, el = experts
    if el != combine.shape[-1]:
        combine = combine[..., off:off + el]
    expert_out = _expert_ffn(x.reshape(1, b * s, d), p, cfg, dt)     # [El,T,D]
    return torch.einsum("etd,te->td", expert_out,
                        combine.reshape(b * s, el).to(dt)).reshape(b, s, d)


# -- Embedding -----------------------------------------------------------------

def embed_scale_value(cfg: DecoderConfig) -> float:
    """The gemma embedding scale sqrt(hidden), rounded to the activation
    dtype first (as the JAX package does), as a host float: multiplying by
    it launches no host→device copy."""
    return float(torch.tensor(cfg.hidden ** 0.5, dtype=cfg.activation_dtype))


def embed(table, tokens: torch.Tensor, cfg: DecoderConfig) -> torch.Tensor:
    """The rows of ``tokens`` in the embedding ``table``, in the activation
    dtype (``vocab_rows`` over the config's model axis)."""
    return vocab_rows(table, tokens, cfg.vocab_size, model_axis_of(cfg),
                      cfg.activation_dtype)


def vocab_rows(table, tokens: torch.Tensor, vocab: int, tp,
               dt: torch.dtype) -> torch.Tensor:
    """The rows of ``tokens`` in ``table`` in ``dt``. Under the model axis
    ``tp`` the table holds the rank's vocab rows (or all ``vocab`` of them
    where the vocabulary does not divide: the rank reads its ``part``): a
    token outside them reads zero and the ranks' rows are summed over the
    axis (exactly one rank adds a nonzero row, so the sum is the lookup's
    bits)."""
    if tp is None:
        return table[tokens].to(dt)
    lo, hi = axis_part(vocab, tp)
    table = rank_part_of(table, 0, vocab, tp, "vocab")
    local = tokens - lo
    hit = (local >= 0) & (local < hi - lo)
    x = table[local.clamp(0, hi - lo - 1)].to(dt) * hit[..., None].to(dt)
    return C.reduce_from_model(x, tp)


def init_embedding(gen: torch.Generator, cfg: DecoderConfig,
                   dtype=None) -> torch.Tensor:
    return _init(gen, (cfg.vocab_size, cfg.hidden), dtype or cfg.weight_dtype,
                 scale=1.0)
