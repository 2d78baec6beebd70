"""Paged one-token decode attention — port of
``kubeflow_tpu/ops/paged_attention.py`` (``paged_decode_attention`` over
``_kernel``'s ``pl.pallas_call``).

The kernel is CUDA C++ (``csrc/paged_decode.cu``, bound through
``ctypes``); its note there gives the bound and the design. The TPU kernel
walks a sequential (slot, page) grid and keeps the kv-head dimension whole
for Mosaic; the Hopper kernel runs one block per (kv head, slot) that loops
over the slot's pages itself, so nothing carries across blocks.

``paged_decode_attention`` keeps the JAX function's signature and
semantics: page ``j`` of slot ``b`` counts only if ``j * page <=
lengths[b]`` and ``table[b, j] >= 0``; inside a counted page positions past
``lengths[b]`` carry the finite ``NEG_INF``; scores, softmax and the PV sum
are fp32 with no rounding of the probabilities; an int8 pool is
dequantized as ``k * ks[..., None]``; a slot with no counted page outputs
zeros; the output has ``q``'s dtype. It takes the plain version
(``paged_decode_ref``) only for CPU tensors; on CUDA tensors it launches
the kernel (adding one to ``paged_decode_attention.launches``) or raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from kubeflow_tpu_torch.ops import _build
from kubeflow_tpu_torch.ops.attention import NEG_INF

SUPPORTED_HEAD_DIMS = (64, 128)
#: Dynamic shared memory one block may use on an H100 (bytes).
MAX_SMEM = 232448


@functools.lru_cache(maxsize=None)
def _lib():
    """The C entry points, built and bound on first use."""
    lib = _build.load("paged_decode")
    lib.paged_decode.restype = ctypes.c_int
    lib.paged_decode.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 8
                                 + [ctypes.c_float, ctypes.c_void_p])
    lib.paged_decode_smem.restype = ctypes.c_longlong
    lib.paged_decode_smem.argtypes = [ctypes.c_int] * 4
    return lib


def _check_args(q, pool_k, pool_v, pool_ks, pool_vs):
    b, one, h, d = q.shape
    if one != 1:
        raise ValueError("paged decode attention takes one token per slot")
    kh = pool_k.shape[2]
    if h % kh:
        raise ValueError(f"q heads {h} must be a multiple of kv heads {kh}")
    if (pool_ks is None) != (pool_vs is None):
        raise ValueError("pool_ks and pool_vs must be given together")


def paged_decode_ref(q: torch.Tensor, pool_k: torch.Tensor,
                     pool_v: torch.Tensor, table: torch.Tensor,
                     lengths: torch.Tensor, *,
                     pool_ks: Optional[torch.Tensor] = None,
                     pool_vs: Optional[torch.Tensor] = None,
                     sm_scale: Optional[float] = None) -> torch.Tensor:
    """Plain version: gather every slot's pages, dequantize int8 pages, and
    run an fp32 masked softmax. Positions of uncounted pages (unmapped, or
    starting past the length) get no weight at all; positions past the
    length inside a counted page get ``NEG_INF``; a row with no counted
    page outputs zeros."""
    _check_args(q, pool_k, pool_v, pool_ks, pool_vs)
    b, _, h, d = q.shape
    _, pg, kh, _ = pool_k.shape
    g = h // kh
    mpp = table.shape[1]
    scale = sm_scale if sm_scale is not None else d ** -0.5
    idx = table.long().clamp(min=0)
    k = pool_k[idx].float()                              # [B,mpp,pg,K,D]
    v = pool_v[idx].float()
    if pool_ks is not None:
        k = k * pool_ks[idx].float()[..., None]
        v = v * pool_vs[idx].float()[..., None]
    k = k.reshape(b, mpp * pg, kh, d)
    v = v.reshape(b, mpp * pg, kh, d)
    pos = torch.arange(mpp * pg, device=q.device)
    page_start = (torch.arange(mpp, device=q.device) * pg)[None, :]
    counted = (table >= 0) & (page_start <= lengths[:, None])     # [B,mpp]
    counted = counted.repeat_interleave(pg, dim=1)                # [B,S]
    inside = pos[None, :] <= lengths[:, None]
    qg = q.float().reshape(b, kh, g, d)
    s = torch.einsum("bkgd,bskd->bkgs", qg, k) * scale
    s = torch.where(inside[:, None, None, :], s, NEG_INF)
    s = torch.where(counted[:, None, None, :], s, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isinf(m), torch.zeros_like(m), m)
    p = torch.exp(s - m)                                 # 0 where uncounted
    v = torch.where((counted & inside)[:, :, None, None], v, 0.0)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bkgs,bskd->bkgd", p, v)
    o = o / torch.where(l == 0.0, torch.ones_like(l), l)
    return o.reshape(b, 1, h, d).to(q.dtype)


def _launch(q, pool_k, pool_v, table, lengths, pool_ks, pool_vs,
            scale: float) -> torch.Tensor:
    b, _, h, d = q.shape
    p_total, pg, kh, _ = pool_k.shape
    quantized = pool_ks is not None
    want = torch.int8 if quantized else torch.bfloat16
    named = [("q", q, torch.bfloat16), ("pool_k", pool_k, want),
             ("pool_v", pool_v, want)]
    if quantized:
        named += [("pool_ks", pool_ks, torch.float32),
                  ("pool_vs", pool_vs, torch.float32)]
    for name, t, dt in named:
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"paged_decode_attention: {name} on {t.device}; "
                             "the kernel takes CUDA tensors on one device")
        if t.dtype != dt:
            raise ValueError(f"paged_decode_attention: {name} is {t.dtype}; "
                             f"the kernel takes {dt}")
        if not t.is_contiguous():
            raise ValueError(f"paged_decode_attention: {name} is not "
                             "contiguous")
    if d not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"paged_decode_attention: head_dim {d} not in "
                         f"{SUPPORTED_HEAD_DIMS}")
    if pg % 16:
        raise ValueError(f"paged_decode_attention: page size {pg} is not a "
                         "multiple of 16")
    if pool_v.shape != pool_k.shape or (
            quantized and (pool_ks.shape != pool_k.shape[:3]
                           or pool_vs.shape != pool_k.shape[:3])):
        raise ValueError("paged_decode_attention: pool shapes disagree")
    if table.shape[0] != b or lengths.shape != (b,):
        raise ValueError("paged_decode_attention: table/lengths batch "
                         "differs from q")
    smem = _lib().paged_decode_smem(d, pg, h // kh, int(quantized))
    if smem > MAX_SMEM:
        raise ValueError(f"paged_decode_attention: {h // kh} query heads per "
                         f"kv head need {smem} B of shared memory per block "
                         f"(the card has {MAX_SMEM})")
    table = table.to(device=q.device, dtype=torch.int32).contiguous()
    lengths = lengths.to(device=q.device, dtype=torch.int64).contiguous()
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _lib().paged_decode(
        q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(),
        pool_ks.data_ptr() if quantized else None,
        pool_vs.data_ptr() if quantized else None,
        table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        b, h, kh, d, pg, p_total, table.shape[1], int(quantized),
        float(scale), stream)
    _build.check(err, f"paged_decode(B={b}, H={h}, KH={kh}, D={d}, "
                      f"page={pg}, mpp={table.shape[1]}, "
                      f"int8={quantized})")
    return out


def paged_decode_attention(
    q: torch.Tensor,                  # [B, 1, H, D] — one decode token per slot
    pool_k: torch.Tensor,             # [P, page, K, D]
    pool_v: torch.Tensor,             # [P, page, K, D]
    table: torch.Tensor,              # [B, mpp] int32 page ids (-1 = unmapped)
    lengths: torch.Tensor,            # [B] position being decoded (attend <=)
    *,
    pool_ks: Optional[torch.Tensor] = None,   # [P, page, K] f32 (int8 pools)
    pool_vs: Optional[torch.Tensor] = None,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """Exact decode attention over the page pool; returns [B, 1, H, D]. If
    ``pool_ks``/``pool_vs`` are given, ``pool_k``/``pool_v`` hold int8
    pages with per-token-per-head scales."""
    _check_args(q, pool_k, pool_v, pool_ks, pool_vs)
    scale = sm_scale if sm_scale is not None else q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return paged_decode_ref(q, pool_k, pool_v, table, lengths,
                                pool_ks=pool_ks, pool_vs=pool_vs,
                                sm_scale=scale)
    out = _launch(q, pool_k, pool_v, table, lengths, pool_ks, pool_vs, scale)
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0
