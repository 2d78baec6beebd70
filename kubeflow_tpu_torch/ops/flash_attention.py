"""Flash attention, forward and backward — port of
``kubeflow_tpu/ops/flash_attention.py`` (``flash_attention`` over the
``_flash`` custom VJP: ``_flash_fwd``'s ``pl.pallas_call`` forward and
``_flash_bwd_pallas``'s two backward ``pl.pallas_call`` sites).

The kernels are CUDA C++ bound through ``ctypes``: ``csrc/flash_fwd.cu``
(o and the per-row log-sum-exp) and ``csrc/flash_bwd.cu`` (dK/dV summed
over each GQA group, and dQ); their notes there give the bounds and the
designs. All three kernels load their tiles with TMA, so the tensors in
``TMA_INPUTS`` must start on a 16-byte boundary.
``FlashAttentionFn`` is the ``torch.autograd.Function`` that ties them
together as the JAX package's custom VJP does: the forward saves ``(q, k,
v, o, lse)``, the backward forms ``delta = rowsum(dO·O)`` in fp32
(outside the kernels, as the JAX package does) and runs the two backward
kernels. This module
keeps the JAX function's public layout — ``[B, S, H, D]`` in and out,
swapped to ``[B, H, S, D]`` for the kernels — and ``flash_attention``
also returns ``lse [B, H, Sq]``.

Every wrapper takes its plain version (``flash_ref``, ``flash_bwd_ref``)
only for CPU tensors; on CUDA tensors it launches its kernel (adding one to
its ``launches`` count) or raises. The Mosaic block-fit rule of the TPU
kernels (``_fit_block``) has no counterpart: the kernels mask their ragged
edges, so any sequence length runs.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from kubeflow_tpu_torch.ops import _build
from kubeflow_tpu_torch.ops.attention import NEG_INF, _repeat_kv

SUPPORTED_HEAD_DIMS = (64, 128)


@functools.lru_cache(maxsize=None)
def _flash_fwd_bf16():
    """The C entry point, built and bound on first use."""
    fn = _build.load("flash_fwd").flash_fwd_bf16
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_float,
                      ctypes.c_void_p])
    return fn


@functools.lru_cache(maxsize=None)
def _flash_bwd_bf16(name: str, defines: tuple[str, ...] = ()):
    """``flash_bwd_dkdv_bf16`` (8 pointers) or ``flash_bwd_dq_bf16`` (7),
    built (with ``defines``, a variant) and bound on first use."""
    fn = getattr(_build.load("flash_bwd", defines), name)
    fn.restype = ctypes.c_int
    n_ptr = 8 if name == "flash_bwd_dkdv_bf16" else 7
    fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 8
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_float,
                      ctypes.c_void_p])
    return fn


def _causal_keep(sq: int, skv: int, q_offset: int, device) -> torch.Tensor:
    qpos = torch.arange(sq, device=device)[:, None] + q_offset
    kpos = torch.arange(skv, device=device)[None, :]
    return kpos <= qpos


def flash_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool, sm_scale: float, softcap: Optional[float],
              q_offset: int):
    """Plain version on the kernel layout: q [B,H,Sq,D], k/v [B,KH,Skv,D] →
    (o [B,H,Sq,D] in q's dtype, lse [B,H,Sq] fp32). fp32 scores, the
    probabilities cast to v's dtype for the PV product (as the kernel
    does), normalised at the end; rows with no weight give 0."""
    h, kh = q.shape[1], k.shape[1]
    kf = _repeat_kv(k.transpose(1, 2), h // kh).transpose(1, 2)
    vr = _repeat_kv(v.transpose(1, 2), h // kh).transpose(1, 2)
    s = torch.matmul(q.float(), kf.float().transpose(-1, -2)) * sm_scale
    if softcap is not None:
        s = torch.tanh(s / softcap) * softcap
    if causal:
        keep = _causal_keep(q.shape[2], k.shape[2], q_offset, q.device)
        s = s.masked_fill(~keep, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    safe = torch.where(l == 0.0, torch.ones_like(l), l)
    o = torch.matmul(p.to(v.dtype).float(), vr.float()) / safe
    return o.to(q.dtype), (m + torch.log(safe))[..., 0]


def _bwd_ref(q, k, v, do, lse, delta, *, causal: bool, sm_scale: float,
             softcap: Optional[float], q_offset: int):
    """The plain backward core on the kernel layout (fp32 throughout, one
    pass over the whole kv length): a translation of the JAX package's
    ``bwd_impl="xla"`` oracle (``_flash_vjp_bwd``), with p cast to dO's
    dtype before the dV product and dS to q's dtype before the dK and dQ
    products, where the TPU kernels cast them (a no-op at fp32). Returns
    (dq, dk, dv) in the input dtypes."""
    b, h, sq, d = q.shape
    _, kh, skv, _ = k.shape
    g = h // kh
    qg = q.float().reshape(b, kh, g, sq, d)
    dog = do.float().reshape(b, kh, g, sq, d)
    kf, vf = k.float(), v.float()
    lse_g = lse.float().reshape(b, kh, g, sq, 1)
    delta_g = delta.float().reshape(b, kh, g, sq, 1)
    s_raw = torch.einsum("bkgqd,bkmd->bkgqm", qg, kf) * sm_scale
    s = s_raw
    if softcap is not None:
        s = torch.tanh(s_raw / softcap) * softcap
    if causal:
        s = s.masked_fill(~_causal_keep(sq, skv, q_offset, q.device), NEG_INF)
    p = torch.exp(s - lse_g)
    # Fully-masked rows have lse == NEG_INF too: exp(0) would be 1.
    p = torch.where(s <= NEG_INF / 2, torch.zeros_like(p), p)
    dv = torch.einsum("bkgqm,bkgqd->bkmd", p.to(do.dtype).float(), dog)
    dp = torch.einsum("bkgqd,bkmd->bkgqm", dog, vf)
    ds = p * (dp - delta_g)
    if softcap is not None:
        ds = ds * (1.0 - torch.tanh(s_raw / softcap) ** 2)
    ds = (ds * sm_scale).to(q.dtype).float()
    dq = torch.einsum("bkgqm,bkmd->bkgqd", ds, kf).reshape(b, h, sq, d)
    dk = torch.einsum("bkgqm,bkgqd->bkmd", ds, qg)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """rowsum(dO · O) in fp32: the softmax-backward correction term."""
    return (do.float() * o.float()).sum(dim=-1)


def flash_bwd_ref(q, k, v, o, lse, do, *, causal: bool, sm_scale: float,
                  softcap: Optional[float], q_offset: int):
    """Plain flash backward on the kernel layout from the forward's saved
    ``(q, k, v, o, lse)`` and the output cotangent ``do``; returns (dq, dk,
    dv) with dk/dv at the KH size."""
    return _bwd_ref(q, k, v, do, lse, _delta(o, do), causal=causal,
                    sm_scale=sm_scale, softcap=softcap, q_offset=q_offset)


def _check(name: str, tensors: dict, kinds: dict) -> None:
    """Device, dtype and contiguity of a kernel call's inputs."""
    dev = next(iter(tensors.values())).device
    for n, t in tensors.items():
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: {n} on {t.device}; the kernel takes "
                             "CUDA tensors on one device")
        if t.dtype != kinds[n]:
            raise ValueError(f"{name}: {n} is {t.dtype}; the kernel takes "
                             f"{kinds[n]}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {n} is not contiguous")
    _check_tma(name, tensors)


#: The inputs each kernel reads through TMA tensor maps. Both backward
#: kernels read lse and delta rows with plain loads (a row starts anywhere).
TMA_INPUTS = {"flash_attention": ("q", "k", "v"),
              "flash_bwd_dkdv": ("q", "k", "v", "do"),
              "flash_bwd_dq": ("q", "k", "v", "do")}


def _check_tma(name: str, tensors: dict) -> None:
    """A TMA tensor map's global address must be 16-byte aligned: check
    the inputs of ``TMA_INPUTS[name]``. (Their row strides, D * 2 bytes with
    D in ``SUPPORTED_HEAD_DIMS``, and plane strides are multiples of 16
    bytes once the tensor is contiguous.)"""
    _build.check_tma_aligned(name, tensors, TMA_INPUTS[name])


def _check_shapes(name: str, q, k, v) -> None:
    d, h, kh = q.shape[-1], q.shape[1], k.shape[1]
    if d not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {d} not in {SUPPORTED_HEAD_DIMS}")
    if h % kh:
        raise ValueError(f"{name}: {h} q heads not a multiple of {kh} kv "
                         "heads")
    if v.shape != k.shape:
        raise ValueError(f"{name}: k and v shapes differ")


def _launch(qt, kt, vt, *, causal: bool, sm_scale: float,
            softcap: Optional[float], q_offset: int):
    b, h, sq, d = qt.shape
    _, kh, skv, _ = kt.shape
    bf = torch.bfloat16
    _check("flash_attention", {"q": qt, "k": kt, "v": vt},
           {"q": bf, "k": bf, "v": bf})
    _check_shapes("flash_attention", qt, kt, vt)
    o = torch.empty_like(qt)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=qt.device)
    stream = torch.cuda.current_stream(qt.device).cuda_stream
    err = _flash_fwd_bf16()(
        qt.data_ptr(), kt.data_ptr(), vt.data_ptr(), o.data_ptr(),
        lse.data_ptr(), b, h, kh, sq, skv, d, int(causal), q_offset,
        float(sm_scale), int(softcap is not None), float(softcap or 0.0),
        stream)
    _build.check(err, f"flash_fwd_bf16(B={b}, H={h}, KH={kh}, Sq={sq}, "
                      f"Skv={skv}, D={d})")
    return o, lse


def _launch_bwd(which: str, q, k, v, do, lse, delta, *, causal: bool,
                sm_scale: float, softcap: Optional[float], q_offset: int,
                defines: tuple[str, ...] = ()):
    """Launch ``flash_bwd_dkdv_bf16`` (returns (dk, dv)) or
    ``flash_bwd_dq_bf16`` (returns dq) on the kernel layout; ``defines``
    select a variant build of ``csrc/flash_bwd.cu`` (to measure one)."""
    b, h, sq, d = q.shape
    _, kh, skv, _ = k.shape
    bf, f32 = torch.bfloat16, torch.float32
    name = f"flash_bwd_{which}"
    _check(name, {"q": q, "k": k, "v": v, "do": do, "lse": lse,
                  "delta": delta},
           {"q": bf, "k": bf, "v": bf, "do": bf, "lse": f32, "delta": f32})
    _check_shapes(name, q, k, v)
    if do.shape != q.shape or lse.shape != (b, h, sq) \
            or delta.shape != (b, h, sq):
        raise ValueError(f"{name}: do {tuple(do.shape)}, lse "
                         f"{tuple(lse.shape)}, delta {tuple(delta.shape)} "
                         f"do not match q {tuple(q.shape)}")
    if which == "dkdv":
        outs = (torch.empty_like(k), torch.empty_like(v))
    else:
        outs = (torch.empty_like(q),)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _flash_bwd_bf16(f"{name}_bf16", defines)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), *(t.data_ptr() for t in outs),
        b, h, kh, sq, skv, d, int(causal), q_offset, float(sm_scale),
        int(softcap is not None), float(softcap or 0.0), stream)
    _build.check(err, f"{name}_bf16(B={b}, H={h}, KH={kh}, Sq={sq}, "
                      f"Skv={skv}, D={d})")
    return outs


def flash_bwd_dkdv(q, k, v, do, lse, delta, *, causal: bool = True,
                   sm_scale: float, softcap: Optional[float] = None,
                   q_offset: int = 0):
    """Kernel 7 on the kernel layout: (dk, dv) [B,KH,Skv,D], each summed
    over its GQA group, from q, do [B,H,Sq,D], k, v, and the fp32 lse and
    delta [B,H,Sq]."""
    if q.device.type == "cpu":
        _, dk, dv = _bwd_ref(q, k, v, do, lse, delta, causal=causal,
                             sm_scale=sm_scale, softcap=softcap,
                             q_offset=q_offset)
        return dk, dv
    dk, dv = _launch_bwd("dkdv", q, k, v, do, lse, delta, causal=causal,
                         sm_scale=sm_scale, softcap=softcap,
                         q_offset=q_offset)
    flash_bwd_dkdv.launches += 1
    return dk, dv


def flash_bwd_dq(q, k, v, do, lse, delta, *, causal: bool = True,
                 sm_scale: float, softcap: Optional[float] = None,
                 q_offset: int = 0):
    """Kernel 8 on the kernel layout: dq [B,H,Sq,D] over the kv sweep."""
    if q.device.type == "cpu":
        return _bwd_ref(q, k, v, do, lse, delta, causal=causal,
                        sm_scale=sm_scale, softcap=softcap,
                        q_offset=q_offset)[0]
    (dq,) = _launch_bwd("dq", q, k, v, do, lse, delta, causal=causal,
                        sm_scale=sm_scale, softcap=softcap, q_offset=q_offset)
    flash_bwd_dq.launches += 1
    return dq


def flash_bwd(q, k, v, o, lse, do, *, causal: bool, sm_scale: float,
              softcap: Optional[float], q_offset: int):
    """The backward of ``FlashAttentionFn`` on the kernel layout: delta in
    plain torch, then both kernels (the plain core on the CPU, once)."""
    kw = dict(causal=causal, sm_scale=sm_scale, softcap=softcap,
              q_offset=q_offset)
    if q.device.type == "cpu":
        return flash_bwd_ref(q, k, v, o, lse, do, **kw)
    do = do.contiguous()
    delta = _delta(o, do)
    dk, dv = flash_bwd_dkdv(q, k, v, do, lse, delta, **kw)
    dq = flash_bwd_dq(q, k, v, do, lse, delta, **kw)
    return dq, dk, dv


class FlashAttentionFn(torch.autograd.Function):
    """Flash attention on the kernel layout with its gradient — the
    ``_flash`` custom VJP. ``apply(q, k, v, causal, sm_scale, softcap,
    q_offset)`` returns ``(o, lse)``; lse carries no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale, softcap, q_offset):
        kw = dict(causal=causal, sm_scale=sm_scale, softcap=softcap,
                  q_offset=q_offset)
        if q.device.type == "cpu":
            o, lse = flash_ref(q, k, v, **kw)
        else:
            o, lse = _launch(q, k, v, **kw)
            flash_attention.launches += 1
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.kw = kw
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_bwd(q, k, v, o, lse, do, **ctx.kw)
        return dq, dk, dv, None, None, None, None


def flash_attention(
    q: torch.Tensor,                  # [B, Sq, H, D]
    k: torch.Tensor,                  # [B, Skv, K, D]
    v: torch.Tensor,                  # [B, Skv, K, D]
    *,
    causal: bool = True,
    q_offset: int = 0,
    logits_softcap: Optional[float] = None,
    sm_scale: Optional[float] = None,
):
    """Flash attention with GQA; returns ``(o [B, Sq, H, D], lse [B, H,
    Sq])``, differentiable in q, k and v through ``FlashAttentionFn``.
    ``q_offset`` is the static absolute position of query 0 (the prefill
    path); a decode with a per-row cache offset goes through the plain
    attention instead. ``flash_attention.launches`` counts forward kernel
    launches (a remat replay launches again)."""
    if isinstance(q_offset, torch.Tensor):
        raise TypeError("flash_attention needs a static int q_offset")
    d = q.shape[-1]
    scale = sm_scale if sm_scale is not None else d ** -0.5
    qt = q.transpose(1, 2).contiguous()
    kt = k.transpose(1, 2).contiguous()
    vt = v.transpose(1, 2).contiguous()
    o, lse = FlashAttentionFn.apply(qt, kt, vt, causal, float(scale),
                                    logits_softcap, int(q_offset))
    return o.transpose(1, 2), lse


flash_attention.launches = 0
flash_bwd_dkdv.launches = 0
flash_bwd_dq.launches = 0
