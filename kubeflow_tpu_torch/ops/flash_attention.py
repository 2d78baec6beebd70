"""Flash-attention forward — port of ``kubeflow_tpu/ops/flash_attention.py``
(``flash_attention`` over ``_flash_fwd``'s ``pl.pallas_call``).

The kernel is CUDA C++ (``csrc/flash_fwd.cu``, bound through ``ctypes``);
its note there gives the bound and the design. This module keeps the JAX
function's public layout — ``[B, S, H, D]`` in and out, swapped to
``[B, H, S, D]`` for the kernel — and also returns the per-row
log-sum-exp ``lse [B, H, Sq]`` the backward will need.

``flash_attention`` takes the plain version (``flash_ref``) only for CPU
tensors; on CUDA tensors it launches the kernel (adding one to
``flash_attention.launches``) or raises. The Mosaic block-fit rule of the
TPU kernel (``_fit_block``) has no counterpart: the kernel masks its
ragged edges, so any sequence length runs.
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
        sq, skv = q.shape[2], k.shape[2]
        qpos = torch.arange(sq, device=q.device)[:, None] + q_offset
        kpos = torch.arange(skv, device=q.device)[None, :]
        s = s.masked_fill(kpos > qpos, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    safe = torch.where(l == 0.0, torch.ones_like(l), l)
    o = torch.matmul(p.to(v.dtype).float(), vr.float()) / safe
    return o.to(q.dtype), (m + torch.log(safe))[..., 0]


def _launch(qt, kt, vt, *, causal: bool, sm_scale: float,
            softcap: Optional[float], q_offset: int):
    b, h, sq, d = qt.shape
    _, kh, skv, _ = kt.shape
    for name, t in (("q", qt), ("k", kt), ("v", vt)):
        if t.device.type != "cuda" or t.device != qt.device:
            raise ValueError(f"flash_attention: {name} on {t.device}; the "
                             "kernel takes CUDA tensors on one device")
        if t.dtype != torch.bfloat16:
            raise ValueError(f"flash_attention: {name} is {t.dtype}; the "
                             "kernel takes bfloat16")
    if d not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {d} not in "
                         f"{SUPPORTED_HEAD_DIMS}")
    if h % kh:
        raise ValueError(f"flash_attention: {h} q heads not a multiple of "
                         f"{kh} kv heads")
    if vt.shape != kt.shape:
        raise ValueError("flash_attention: k and v shapes differ")
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
    Sq])``. ``q_offset`` is the static absolute position of query 0 (the
    prefill path); a decode with a per-row cache offset goes through the
    plain attention instead."""
    if isinstance(q_offset, torch.Tensor):
        raise TypeError("flash_attention needs a static int q_offset")
    d = q.shape[-1]
    scale = sm_scale if sm_scale is not None else d ** -0.5
    qt = q.transpose(1, 2).contiguous()
    kt = k.transpose(1, 2).contiguous()
    vt = v.transpose(1, 2).contiguous()
    if q.device.type == "cpu":
        o, lse = flash_ref(qt, kt, vt, causal=causal, sm_scale=scale,
                           softcap=logits_softcap, q_offset=int(q_offset))
    else:
        o, lse = _launch(qt, kt, vt, causal=causal, sm_scale=scale,
                         softcap=logits_softcap, q_offset=int(q_offset))
        flash_attention.launches += 1
    return o.transpose(1, 2), lse


flash_attention.launches = 0
