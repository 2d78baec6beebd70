"""Fused output projection + softmax cross-entropy, forward and backward —
port of ``kubeflow_tpu/ops/fused_xent.py`` (``fused_cross_entropy`` over
the ``_fused_ce`` custom VJP: ``_xent_fwd``'s ``pl.pallas_call`` and
``_xent_bwd``'s two).

The kernels are CUDA C++ bound through ``ctypes``: ``csrc/fused_xent.cu``
(its notes give the bound and the design). ``xent_fwd`` returns per-row
``(nll, lse, correct)``; ``xent_bwd`` returns ``(d_hidden, d_head)`` from
the saved lse, recomputing the logits once per vocab chunk of
``VOCAB_CHUNK`` columns. ``[T, V]`` logits never exist on the card.
``FusedCrossEntropyFn`` ties them together as the JAX custom VJP does: it
saves ``(h, W, targets, lse)``; ``correct`` and the targets get no
gradient.

The kernel takes ``h [T, D]`` and ``W [D, V]`` in bf16, both row-major (the
JAX layout of ``lm_head``), with D and V multiples of 8; a tied head
(``embed.T``, a transposed view) is made contiguous first, one copy of the
head. Targets are int32 (the port's int64 tokens are converted); one
outside ``[0, V)`` picks nothing, so its nll is the lse, as on the TPU.

``shard_stats`` gives one vocab shard's per-row statistics (lse, picked
logit, row max, correct) for a vocab-parallel CE over a ``model`` axis
(``parallel/vocab_parallel.py``), the row max from the forward's
per-range maxima, which it already writes; a ragged last vocab tile is
masked by the kernels (−∞ in the forward, TMA's zero fill in the
backward).

Each wrapper takes its plain version (``xent_fwd_ref``, ``xent_bwd_ref``)
only for CPU tensors; on CUDA tensors it launches its kernels or raises.
``xent_fwd.launches`` counts forward launches; ``xent_bwd`` launches the
d_hidden and d_head kernels together and counts each on its own counter,
``dh_kernel.launches`` and ``dw_kernel.launches``.
"""

from __future__ import annotations

import ctypes
import functools
from types import SimpleNamespace
from typing import Optional

import torch

from kubeflow_tpu_torch.ops import _build

#: Vocab columns per backward chunk: the chunk's dl scratch is [T, 16384]
#: bf16 (134 MB at T = 4096). Each chunk reads and writes d_hidden's fp32
#: [T, D] accumulator once, so wider chunks pass over it less often; the
#: scratch and the accumulator must stay within an eighth of the fp32
#: [T, V] logits (``chip_smoke.py``'s memory probe).
VOCAB_CHUNK = 16384
TILE = 256                  # the forward's vocab tile (columns)
ROW_TILE = 128              # its row tile


# -- plain versions (the CPU path, and the card's reference) -------------------

def _logits_ref(h2: torch.Tensor, w: torch.Tensor,
                softcap: Optional[float]) -> torch.Tensor:
    s = h2.float() @ w.float()
    if softcap is not None:
        s = torch.tanh(s / softcap) * softcap
    return s


def _onehot(t: torch.Tensor, vocab: int) -> torch.Tensor:
    """fp32 [T, V] one-hot of the targets; a row whose target lies outside
    [0, V) is all zeros."""
    valid = (t >= 0) & (t < vocab)
    oh = torch.zeros((t.shape[0], vocab), dtype=torch.float32,
                     device=t.device)
    oh[valid, t[valid].long()] = 1.0
    return oh


def xent_fwd_ref(h2: torch.Tensor, w: torch.Tensor, t: torch.Tensor,
                 softcap: Optional[float] = None, row_max: bool = False):
    """Plain forward on the kernel layout, materializing the logits: h2
    [T, D], w [D, V], t [T] integer → (nll, lse, correct), each fp32 [T],
    and with ``row_max`` each row's largest logit after them. Argmax ties
    go to the lowest index."""
    s = _logits_ref(h2, w, softcap)
    lse = torch.logsumexp(s, dim=-1)
    picked = (s * _onehot(t, w.shape[1])).sum(dim=-1)
    correct = (s.argmax(dim=-1) == t).float()
    if row_max:
        return lse - picked, lse, correct, s.amax(dim=-1)
    return lse - picked, lse, correct


def _dlogits_ref(s: torch.Tensor, t: torch.Tensor, lse: torch.Tensor,
                 g: torch.Tensor, softcap: Optional[float]) -> torch.Tensor:
    """fp32 d_logits [T, V] from the (capped) logits ``s`` — the TPU
    kernels' ``_dlogits``: ``(exp(s - lse) - onehot) * g``, times ``1 -
    (s / c)^2`` with a softcap."""
    dl = torch.exp(s - lse.float()[:, None])
    dl.sub_(_onehot(t, s.shape[1])).mul_(g.float()[:, None])
    if softcap is not None:
        dl.mul_(1.0 - (s / softcap) ** 2)
    return dl


def xent_bwd_ref(h2: torch.Tensor, w: torch.Tensor, t: torch.Tensor,
                 lse: torch.Tensor, g: torch.Tensor,
                 softcap: Optional[float] = None):
    """Plain backward (``_dlogits`` and the two products) from the saved
    lse and the nll cotangent ``g`` [T]: dl is cast to W's dtype before
    the d_hidden product and to h's before the d_head product, where the
    TPU kernels cast it. Returns (dh [T, D] in h's dtype, dw [D, V] in W's
    dtype)."""
    dl = _dlogits_ref(_logits_ref(h2, w, softcap), t, lse, g, softcap)
    dh = dl.to(w.dtype).float() @ w.float().T
    dw = h2.float().T @ dl.to(h2.dtype).float()
    return dh.to(h2.dtype), dw.to(w.dtype)


def reference_cross_entropy(hidden: torch.Tensor, head: torch.Tensor,
                            targets: torch.Tensor, *,
                            logits_softcap: Optional[float] = None):
    """The unfused oracle (materializes the logits): ``(nll, correct)``,
    fp32 with ``targets``' shape."""
    nll, _, correct = xent_fwd_ref(hidden.reshape(-1, hidden.shape[-1]),
                                   head, targets.reshape(-1), logits_softcap)
    return nll.reshape(targets.shape), correct.reshape(targets.shape)


# -- kernels -------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _entry(name: str):
    """``fused_xent_fwd_bf16`` or ``fused_xent_bwd_bf16``, built and bound
    on first use."""
    fn = getattr(_build.load("fused_xent"), name)
    fn.restype = ctypes.c_int
    if name == "fused_xent_fwd_bf16":
        fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 5
                       + [ctypes.c_float, ctypes.c_void_p])
    elif name == "fused_xent_bwd_bf16":
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 5
                       + [ctypes.c_float, ctypes.c_void_p])
    else:
        fn.argtypes = [ctypes.POINTER(ctypes.c_int)]
    return fn


def _check(name: str, h2, w, t, *rows) -> None:
    """What the kernels take: CUDA tensors on one device; bf16 h [T, D]
    and W [D, V], row-major, D and V multiples of 8; int32 targets and fp32
    per-row vectors [T]; all contiguous. ``_check_tma`` checks alignment."""
    dev = h2.device
    for x in (h2, w, t, *rows):
        if x.device.type != "cuda" or x.device != dev:
            raise ValueError(f"{name}: a tensor on {x.device}; the kernel "
                             "takes CUDA tensors on one device")
    if h2.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise ValueError(f"{name}: h {h2.dtype}, W {w.dtype}; the kernel "
                         "takes bf16")
    rows_, d = h2.shape
    if w.dim() != 2 or w.shape[0] != d:
        raise ValueError(f"{name}: W {tuple(w.shape)} does not match hidden "
                         f"{d}")
    if d % 8 or w.shape[1] % 8:
        raise ValueError(f"{name}: D = {d} and V = {w.shape[1]} must be "
                         "multiples of 8 (16-byte rows)")
    if t.dtype != torch.int32 or t.shape != (rows_,):
        raise ValueError(f"{name}: targets {t.dtype} {tuple(t.shape)}; the "
                         f"kernel takes int32 [{rows_}]")
    for x in rows:
        if x.dtype != torch.float32 or x.shape != (rows_,):
            raise ValueError(f"{name}: a row vector {x.dtype} "
                             f"{tuple(x.shape)}; the kernel takes fp32 "
                             f"[{rows_}]")
    for x in (h2, w, t, *rows):
        if not x.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")


#: The tensors each entry point reads through TMA tensor maps (the dl
#: scratch twice: K-major for d_hidden, MN-major for d_head). Targets, lse
#: and g are read with plain loads: they may start anywhere.
TMA_INPUTS = {"xent_fwd": ("h", "w"), "xent_bwd": ("h", "w", "scratch")}


def _check_tma(name: str, tensors: dict) -> None:
    """A TMA tensor map's global address must be 16-byte aligned: check
    the tensors of ``TMA_INPUTS[name]``. (Their row strides, D, V and the
    chunk width times 2 bytes, are multiples of 16 once D and V are
    multiples of 8.)"""
    _build.check_tma_aligned(name, tensors, TMA_INPUTS[name])


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=None)
def forward_slots(device: torch.device) -> int:
    """Forward blocks the card runs at once: the SMs times the blocks per
    SM that the CUDA runtime reports for the forward kernel."""
    blocks = ctypes.c_int(0)
    _build.check(_entry("fused_xent_fwd_blocks_per_sm")(ctypes.byref(blocks)),
                 "fused_xent_fwd_blocks_per_sm")
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return blocks.value * sms


def _tiles_per_range(rows: int, vocab: int, slots: int) -> int:
    """Vocab tiles per forward block. A block takes one row tile and one
    range of vocab tiles, and the card runs ``slots`` blocks at once, so
    the split is the one that minimises waves of ``slots`` blocks × tiles
    per block, among splits of at most one wave's blocks (which keeps the
    partials and their combine small): T = 4096 gives 32 row tiles of 128,
    V = 128256 gives 501 tiles of 256, and at 132 slots (132 SMs of one
    block) 4 ranges of 126 tiles fill 128 of them in one wave where 5
    ranges would take two."""
    row_tiles, n_tiles = _cdiv(rows, ROW_TILE), _cdiv(vocab, TILE)
    best = None
    for ranges in range(1, min(n_tiles, _cdiv(slots, row_tiles)) + 1):
        per = _cdiv(n_tiles, ranges)
        cost = (_cdiv(row_tiles * _cdiv(n_tiles, per), slots) * per, per)
        if best is None or cost < best[0]:
            best = (cost, per)
    return best[1]


def xent_fwd(h2: torch.Tensor, w: torch.Tensor, t: torch.Tensor,
             softcap: Optional[float] = None, row_max: bool = False):
    """Kernel 9 on the kernel layout: (nll, lse, correct), each fp32 [T];
    with ``row_max`` also each row's largest logit, the maximum of the
    per-range maxima the kernel writes."""
    if h2.device.type == "cpu":
        return xent_fwd_ref(h2, w, t, softcap, row_max)
    _check("xent_fwd", h2, w, t)
    _check_tma("xent_fwd", {"h": h2, "w": w})
    rows, d = h2.shape
    vocab = w.shape[1]
    per_range = _tiles_per_range(rows, vocab, forward_slots(h2.device))
    ranges = _cdiv(_cdiv(vocab, TILE), per_range)
    f32 = dict(dtype=torch.float32, device=h2.device)
    part = torch.empty((3, ranges, rows), **f32)
    part_i = torch.empty((ranges, rows), dtype=torch.int32, device=h2.device)
    nll, lse, correct = (torch.empty((rows,), **f32) for _ in range(3))
    if rows:
        err = _entry("fused_xent_fwd_bf16")(
            h2.data_ptr(), w.data_ptr(), t.data_ptr(),
            *(part[i].data_ptr() for i in range(3)), part_i.data_ptr(),
            nll.data_ptr(), lse.data_ptr(), correct.data_ptr(), rows, d,
            vocab, per_range, int(softcap is not None),
            float(softcap or 0.0),
            torch.cuda.current_stream(h2.device).cuda_stream)
        _build.check(err, f"fused_xent_fwd_bf16(T={rows}, D={d}, V={vocab})")
        xent_fwd.launches += 1
    if row_max:
        return nll, lse, correct, part[0].amax(dim=0)
    return nll, lse, correct


def xent_bwd(h2: torch.Tensor, w: torch.Tensor, t: torch.Tensor,
             lse: torch.Tensor, g: torch.Tensor,
             softcap: Optional[float] = None):
    """Kernels 10 and 11 on the kernel layout: (dh [T, D], dw [D, V]) in
    bf16 from the saved lse and the nll cotangent ``g`` [T], both products
    from one recompute of the logits per vocab chunk."""
    if h2.device.type == "cpu":
        return xent_bwd_ref(h2, w, t, lse, g, softcap)
    _check("xent_bwd", h2, w, t, lse, g)
    rows, d = h2.shape
    vocab = w.shape[1]
    chunk = min(VOCAB_CHUNK, vocab)
    dh, dw = torch.empty_like(h2), torch.empty_like(w)
    if not rows:
        return dh, dw.zero_()
    scratch = torch.empty((rows, chunk), dtype=torch.bfloat16,
                          device=h2.device)
    _check_tma("xent_bwd", {"h": h2, "w": w, "scratch": scratch})
    acc = torch.empty((rows, d) if vocab > chunk else (1,),
                      dtype=torch.float32, device=h2.device)
    err = _entry("fused_xent_bwd_bf16")(
        h2.data_ptr(), w.data_ptr(), t.data_ptr(), lse.data_ptr(),
        g.data_ptr(), dh.data_ptr(), dw.data_ptr(), scratch.data_ptr(),
        acc.data_ptr(), rows, d, vocab, chunk, int(softcap is not None),
        float(softcap or 0.0),
        torch.cuda.current_stream(h2.device).cuda_stream)
    _build.check(err, f"fused_xent_bwd_bf16(T={rows}, D={d}, V={vocab})")
    dh_kernel.launches += 1
    dw_kernel.launches += 1
    return dh, dw


class FusedCrossEntropyFn(torch.autograd.Function):
    """``apply(h2 [T, D], w [D, V], t [T] int32, softcap)`` → ``(nll,
    correct)``, fp32 [T]; differentiable in h2 and w — the ``_fused_ce``
    custom VJP."""

    @staticmethod
    def forward(ctx, h2, w, t, softcap):
        nll, lse, correct = xent_fwd(h2, w, t, softcap)
        ctx.save_for_backward(h2, w, t, lse)
        ctx.softcap = softcap
        ctx.mark_non_differentiable(correct)
        return nll, correct

    @staticmethod
    def backward(ctx, dnll, _dcorrect):
        h2, w, t, lse = ctx.saved_tensors
        # The cotangent of a sum arrives expanded (stride 0): one value per
        # row, contiguous, is what the kernel reads.
        g = dnll.float().contiguous()
        dh, dw = xent_bwd(h2, w, t, lse, g, ctx.softcap)
        return dh, dw, None, None


def fused_cross_entropy(
    hidden: torch.Tensor,             # [..., D] (typically [B, S, D])
    head: torch.Tensor,               # [D, V]
    targets: torch.Tensor,            # [...] integer, same leading shape
    *,
    logits_softcap: Optional[float] = None,
):
    """Fused output projection + log-softmax + NLL. Returns ``(nll,
    correct)`` — both fp32 with ``targets``' shape — without materializing
    the ``[..., V]`` logits on the card. Differentiable in ``hidden`` and
    ``head``; ``correct`` (argmax == target) has no gradient."""
    d = hidden.shape[-1]
    if head.dim() != 2 or head.shape[0] != d:
        raise ValueError(f"head {tuple(head.shape)} does not match hidden "
                         f"dim {d}")
    h2 = hidden.reshape(-1, d).contiguous()
    t2 = targets.reshape(-1).to(torch.int32).contiguous()
    nll, correct = FusedCrossEntropyFn.apply(
        h2, head.contiguous(), t2,
        None if logits_softcap is None else float(logits_softcap))
    return nll.reshape(targets.shape), correct.reshape(targets.shape)


def shard_stats(h2: torch.Tensor, w: torch.Tensor, t_local: torch.Tensor,
                softcap: Optional[float] = None) -> torch.Tensor:
    """Kernel 9 on one vocab shard (``t_local`` the targets less the
    shard's first column): fp32 [4, T] rows of (lse, picked logit, row
    max, correct) over the shard's columns."""
    nll, lse, correct, mx = xent_fwd(h2, w, t_local, softcap, row_max=True)
    return torch.stack([lse, lse - nll, mx, correct])


xent_fwd.launches = 0
#: Launch counts of the backward's d_hidden (site 10) and d_head (site 11)
#: kernels, which ``xent_bwd`` launches together.
dh_kernel = SimpleNamespace(launches=0)
dw_kernel = SimpleNamespace(launches=0)
