"""Paged one-token decode attention — port of
``kubeflow_tpu/ops/paged_attention.py`` (``paged_decode_attention`` over
``_kernel``'s ``pl.pallas_call``).

The kernel is CUDA C++ (``csrc/paged_decode.cu``, bound through
``ctypes``); the note there gives the bound and the design. The TPU kernel
walks a sequential (slot, page) grid and keeps the kv-head dimension whole
for Mosaic; on Hopper each slot's page slots are split over several blocks
(flash-decoding): one block per (kv head, slot, split), each writing an
fp32 partial (unnormalised o, running max and sum), and the last block of
each (slot, kv head) to finish merges its splits in a fixed order — one
launch per call. The blocks find the last one through ticket counters
([B·KH] int32 per device, kept here by ``_tickets``: zero between calls,
grown with zeros when a call has more (slot, kv head) pairs, never
shrunk). The number of splits comes from shapes alone (``_num_splits``),
never from ``lengths``, so a call reads nothing back to the host and can
be captured in a CUDA graph; the counters cannot grow while a graph is
being captured, so a call with more pairs than any before it raises there
(run it once before capturing). With one split the kernel writes the
output directly and touches no counter. Calls on one device share its
counters, so they run on one stream at a time.

``paged_decode_attention`` keeps the JAX function's signature and
semantics: page ``j`` of slot ``b`` counts only if ``j * page <=
lengths[b]`` and ``table[b, j] >= 0``; inside a counted page positions past
``lengths[b]`` carry the finite ``NEG_INF``; scores, softmax and the PV sum
are fp32 with no rounding of the probabilities; an int8 pool is
dequantized as ``k * ks[..., None]``; a slot with no counted page outputs
zeros; the output has ``q``'s dtype. It takes the plain version
(``paged_decode_ref``) only for CPU tensors; on CUDA tensors it launches
the kernel (adding one to ``paged_decode_attention.launches``, once per
call) or raises. ``paged_decode_split_ref`` and
``paged_decode_combine_ref`` are the plain versions of the splits and of
their merge.
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
    lib.paged_decode.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 9
                                 + [ctypes.c_float, ctypes.c_void_p])
    lib.paged_decode_smem.restype = ctypes.c_longlong
    lib.paged_decode_smem.argtypes = [ctypes.c_int] * 4
    lib.paged_decode_blocks_per_sm.restype = ctypes.c_int
    lib.paged_decode_blocks_per_sm.argtypes = [ctypes.c_int] * 4
    return lib


@functools.lru_cache(maxsize=None)
def _slots(index: int, d: int, page: int, g: int, quantized: bool) -> int:
    """Split blocks card ``index`` holds at once at these shapes: its SM
    count times the kernel's occupancy per SM."""
    per_sm = _lib().paged_decode_blocks_per_sm(d, page, g, int(quantized))
    if per_sm <= 0:
        raise RuntimeError(f"paged_decode_blocks_per_sm(D={d}, page={page}, "
                           f"g={g}, int8={quantized}) found no occupancy")
    return per_sm * torch.cuda.get_device_properties(
        index).multi_processor_count


#: Ticket counters of the split kernel per device: the buffers handed out,
#: the newest last. A buffer is never freed, since a captured CUDA graph
#: keeps its address.
_TICKETS: dict[torch.device, list[torch.Tensor]] = {}


def _grown(have: Optional[torch.Tensor], n: int,
           device: torch.device) -> torch.Tensor:
    """Counters for ``n`` (slot, kv head) pairs: ``have`` itself when it
    holds at least ``n``, else a new zeroed int32 buffer of ``n`` (never
    smaller than ``have``)."""
    if have is not None and have.numel() >= n:
        return have
    size = max(n, 0 if have is None else have.numel())
    return torch.zeros((size,), dtype=torch.int32, device=device)


def _tickets(device: torch.device, n: int) -> torch.Tensor:
    """The device's counters, grown to ``n`` pairs if need be; raises
    rather than grow while the current stream captures a CUDA graph (the
    new zeros would be written by no replay)."""
    held = _TICKETS.setdefault(device, [])
    have = held[-1] if held else None
    buf = _grown(have, n, device)
    if buf is not have:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f"paged_decode_attention: {n} (slot, kv head) pairs need new "
                "ticket counters while a CUDA graph is capturing; run one "
                "call of this size before capturing")
        held.append(buf)
    return buf


def _num_splits(b: int, kh: int, mpp: int, slots: int) -> int:
    """Splits of each slot's ``mpp`` page slots: enough (kv head, slot,
    split) blocks to fill the ``slots`` the card holds at once, at most one
    split per page slot, and none left without a page slot (split ``s``
    takes ``ceil(mpp / splits)`` of them). Shapes only — reading
    ``lengths`` would cost a host sync and break graph capture."""
    if mpp <= 0:
        return 1
    want = max(1, min(mpp, -(-slots // max(b * kh, 1))))
    pps = -(-mpp // want)                        # page slots per split
    return -(-mpp // pps)


def _check_args(q, pool_k, pool_v, pool_ks, pool_vs):
    b, one, h, d = q.shape
    if one != 1:
        raise ValueError("paged decode attention takes one token per slot")
    kh = pool_k.shape[2]
    if h % kh:
        raise ValueError(f"q heads {h} must be a multiple of kv heads {kh}")
    if (pool_ks is None) != (pool_vs is None):
        raise ValueError("pool_ks and pool_vs must be given together")


def _scores(q, pool_k, pool_v, table, lengths, pool_ks, pool_vs, scale):
    """Every slot's pages gathered and int8 pages dequantized: (s [B, KH,
    g, mpp * page] fp32 scores, ``NEG_INF`` past the length inside a
    counted page and -inf on the positions of uncounted pages (unmapped,
    or starting past the length); v [B, mpp * page, KH, D] fp32, zero
    where no weight may fall)."""
    b, _, h, d = q.shape
    _, pg, kh, _ = pool_k.shape
    g = h // kh
    mpp = table.shape[1]
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
    v = torch.where((counted & inside)[:, :, None, None], v, 0.0)
    return s, v


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
    scale = sm_scale if sm_scale is not None else d ** -0.5
    s, v = _scores(q, pool_k, pool_v, table, lengths, pool_ks, pool_vs,
                   scale)
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isinf(m), torch.zeros_like(m), m)
    p = torch.exp(s - m)                                 # 0 where uncounted
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bkgs,bskd->bkgd", p, v)
    o = o / torch.where(l == 0.0, torch.ones_like(l), l)
    return o.reshape(b, 1, h, d).to(q.dtype)


def paged_decode_split_ref(q: torch.Tensor, pool_k: torch.Tensor,
                           pool_v: torch.Tensor, table: torch.Tensor,
                           lengths: torch.Tensor, splits: int, *,
                           pool_ks: Optional[torch.Tensor] = None,
                           pool_vs: Optional[torch.Tensor] = None,
                           sm_scale: Optional[float] = None):
    """Plain version of the split kernel: split ``s`` attends over page
    slots ``[s * pps, (s + 1) * pps)``, ``pps = ceil(mpp / splits)``, under
    ``paged_decode_ref``'s rules. Returns fp32 (o_part [B, H, splits, D],
    the unnormalised ``sum p v``; ml [B, H, splits, 2], the split's max
    score m and ``l = sum exp(s - m)``); a split with no counted page has
    o = 0, l = 0 and m = -inf."""
    _check_args(q, pool_k, pool_v, pool_ks, pool_vs)
    b, _, h, d = q.shape
    _, pg, kh, _ = pool_k.shape
    g = h // kh
    mpp = table.shape[1]
    scale = sm_scale if sm_scale is not None else d ** -0.5
    s, v = _scores(q, pool_k, pool_v, table, lengths, pool_ks, pool_vs,
                   scale)
    pps = -(-mpp // splits)
    pad = (splits * pps - mpp) * pg                 # trailing empty slots
    s = torch.nn.functional.pad(s, (0, pad), value=float("-inf"))
    v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    s = s.reshape(b, kh, g, splits, pps * pg)
    v = v.reshape(b, splits, pps * pg, kh, d)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - torch.where(torch.isinf(m), torch.zeros_like(m), m))
    l = p.sum(dim=-1)                               # [B, KH, g, splits]
    o = torch.einsum("bkgsn,bsnkd->bkgsd", p, v)
    m = torch.where(l > 0, m[..., 0], float("-inf"))
    ml = torch.stack([m, l], dim=-1)
    return o.reshape(b, h, splits, d), ml.reshape(b, h, splits, 2)


def paged_decode_combine_ref(o_part: torch.Tensor,
                             ml: torch.Tensor) -> torch.Tensor:
    """Plain version of the merge the split kernel's last block does: the
    splits of each (slot, head) merged as ``sum_s w_s o_s / sum_s w_s
    l_s`` with ``w_s = exp(m_s - max m)`` over the splits with l > 0 (a
    split with l = 0 weighs nothing); zeros where every l is 0. Returns
    [B, 1, H, D] fp32."""
    m, l = ml[..., 0], ml[..., 1]
    live = l > 0
    top = torch.where(live, m, float("-inf")).amax(dim=-1, keepdim=True)
    top = torch.where(torch.isinf(top), torch.zeros_like(top), top)
    w = torch.where(live, torch.exp(m - top), torch.zeros_like(m))
    big_l = torch.where(live, w * l, torch.zeros_like(l)).sum(dim=-1)
    o = torch.where(live[..., None], w[..., None] * o_part,
                    torch.zeros_like(o_part)).sum(dim=-2)
    o = o / torch.where(big_l == 0, torch.ones_like(big_l), big_l)[..., None]
    return o.unsqueeze(1)


def _launch(q, pool_k, pool_v, table, lengths, pool_ks, pool_vs,
            scale: float, splits: Optional[int] = None) -> torch.Tensor:
    """Check the inputs and launch the kernel. ``splits`` defaults to
    ``_num_splits`` of the shapes; a caller may name it
    (``chip_smoke.py``'s edge cases do)."""
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
    mpp = table.shape[1]
    if splits is None:
        splits = _num_splits(b, kh, mpp, _slots(q.device.index, d, pg,
                                                h // kh, quantized))
    if splits < 1:
        raise ValueError(f"paged_decode_attention: {splits} splits")
    f32 = torch.float32
    out = torch.empty_like(q)
    o_part = ml = counts = None
    if splits > 1:
        o_part = torch.empty((b, h, splits, d), dtype=f32, device=q.device)
        ml = torch.empty((b, h, splits, 2), dtype=f32, device=q.device)
        counts = _tickets(q.device, b * kh)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _lib().paged_decode(
        q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(),
        pool_ks.data_ptr() if quantized else None,
        pool_vs.data_ptr() if quantized else None,
        table.data_ptr(), lengths.data_ptr(),
        *(None if t is None else t.data_ptr()
          for t in (out, o_part, ml, counts)),
        b, h, kh, d, pg, p_total, mpp, splits, int(quantized),
        float(scale), stream)
    _build.check(err, f"paged_decode(B={b}, H={h}, KH={kh}, D={d}, "
                      f"page={pg}, mpp={mpp}, splits={splits}, "
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
