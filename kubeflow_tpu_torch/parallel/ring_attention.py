"""Sequence/context parallelism: ring attention and the Ulysses head swap
(port of ``kubeflow_tpu/parallel/ring_attention.py``).

- **Ring attention** (``ring_attention``): q/k/v split on the sequence dim
  over a process group (the mesh's ``seq`` axis), rank ``idx`` holding
  the contiguous part ``idx`` (JAX's layout). At step ``t`` a rank attends
  its queries to the K/V part ``(idx - t) % n`` and passes that part on to
  rank ``idx + 1``, so every rank sees every part.
- **Ulysses** (``ulysses_attention``): an all-to-all swaps the sequence
  split for a head split, full attention runs locally, and a second
  all-to-all swaps back.

The ring's per-step block math has two forms. ``impl="pallas"`` (the JAX
name; the default on a CUDA tensor) runs the port's flash kernels per K/V
part under a hand-written backward that is a second ring: dK/dV
accumulators travel in fp32 with their part and dQ accumulates locally,
each step calling the dK/dV and dQ kernels with the *global* lse and
``delta = rowsum(dO·O)``, which makes every part's contribution exact.
For causal attention the (query part, K/V part) relation is one of three
static cases — past part (non-causal flash), own part (causal flash), a
future part (nothing launched) — so the kernels always see
``q_offset = 0``. ``impl="xla"`` is the online-softmax oracle
(``_block_attn_step``), differentiable through autograd-aware rotations.
The schedule is written per step (``ring_fwd_step``, ``ring_bwd_step``,
functions of ``(idx, t, n)``) with the rotation outside, so the
distributed ring and a one-process lockstep drive of ``n`` ranks
(``ring_flash_lockstep``) run the same step code.

Contiguous parts leave the ring unbalanced under a causal mask: rank
``n - 1`` runs ``n`` flash steps and rank 0 one, as in JAX.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from kubeflow_tpu_torch.ops.attention import (
    NEG_INF, _repeat_kv, multi_head_attention,
)
from kubeflow_tpu_torch.ops.flash_attention import (
    _delta, _flash_fwd_impl, flash_bwd_dkdv, flash_bwd_dq,
)
from kubeflow_tpu_torch.parallel.collectives import (
    all_to_all, ring_shift, rotate,
)


def _rank_and_size(group) -> tuple[int, int]:
    if group is None:
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def _block_attn_step(q, k, v, m, l, acc, *, q_start, kv_start, causal,
                     sm_scale, softcap):
    """One online-softmax accumulation step of local Q against one K/V
    part. q: [B,Sq,H,D]; k/v: [B,Skv,H,D]; m/l: [B,H,Sq]; acc:
    [B,Sq,H,D] (fp32). ``q_start``/``kv_start`` are global offsets."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * sm_scale
    if softcap is not None:
        s = torch.tanh(s / softcap) * softcap
    sq, skv = q.shape[1], k.shape[1]
    if causal:
        q_pos = q_start + torch.arange(sq, device=q.device)[:, None]
        kv_pos = kv_start + torch.arange(skv, device=q.device)[None, :]
        s = s.masked_fill(~(kv_pos <= q_pos)[None, None], NEG_INF)
    m_new = torch.maximum(m, s.amax(dim=-1))
    # exp(NEG_INF - NEG_INF) would be 1: zero fully-masked entries.
    p = torch.exp(s - m_new[..., None])
    p = torch.where(s <= NEG_INF / 2, torch.zeros_like(p), p)
    alpha = torch.exp(m - m_new)
    l_new = l * alpha + p.sum(dim=-1)
    pv = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    acc_new = acc * alpha.transpose(1, 2)[..., None] + pv
    return m_new, l_new, acc_new


def _ring_merge(o_acc, lse_acc, o_t, lse_t):
    """Merge a new normalized partial (o_t, lse_t) into the running one
    (both [B,H,Sq,·]): the max-rescaled combine of exp(lse)·o. A masked
    partial carries lse = NEG_INF and adds exactly nothing."""
    m = torch.maximum(lse_acc, lse_t)
    a = torch.exp(lse_acc - m)
    b = torch.exp(lse_t - m)
    denom = a + b
    o_new = (a[..., None] * o_acc
             + b[..., None] * o_t.float()) / denom[..., None]
    return o_new, m + torch.log(denom)


def step_case(idx: int, t: int, n: int, causal: bool) -> str:
    """What rank ``idx`` does at ring step ``t``: "past" (the K/V part is
    wholly before its queries, or attention is not causal), "own" (its
    own part: the causal diagonal) or "future" (wholly masked)."""
    if not causal:
        return "past"
    part = (idx - t) % n
    return "own" if part == idx else ("past" if part < idx else "future")


def ring_fwd_step(qt, kt, vt, o_acc, lse_acc, *, idx: int, t: int, n: int,
                  causal: bool, sm_scale: float, softcap: Optional[float]):
    """One forward step on the kernel layout (q [B,H,Sq,D], k/v
    [B,KH,Skv,D]): the flash forward of the step's case merged into the
    fp32 ``(o_acc, lse_acc)``. A future part launches nothing."""
    case = step_case(idx, t, n, causal)
    if case == "future":
        return o_acc, lse_acc
    o_t, lse_t = _flash_fwd_impl(qt, kt, vt, case == "own", sm_scale,
                                 softcap, 0)
    return _ring_merge(o_acc, lse_acc, o_t, lse_t)


def ring_bwd_step(qt, kt, vt, dot, lse, delta, dq_acc, dk_acc, dv_acc, *,
                  idx: int, t: int, n: int, causal: bool, sm_scale: float,
                  softcap: Optional[float]):
    """One backward step: the dK/dV and dQ kernels of the step's case with
    the global ``lse`` and ``delta``, added into the fp32 accumulators (dK
    and dV those of the K/V part the rank holds at this step). A future
    part launches nothing."""
    case = step_case(idx, t, n, causal)
    if case == "future":
        return dq_acc, dk_acc, dv_acc
    kw = dict(causal=case == "own", sm_scale=sm_scale, softcap=softcap,
              q_offset=0)
    dk, dv = flash_bwd_dkdv(qt, kt, vt, dot, lse, delta, **kw)
    dq = flash_bwd_dq(qt, kt, vt, dot, lse, delta, **kw)
    return dq_acc + dq.float(), dk_acc + dk.float(), dv_acc + dv.float()


def _fwd_init(qt):
    b, h, sq, d = qt.shape
    return (torch.zeros((b, h, sq, d), dtype=torch.float32, device=qt.device),
            torch.full((b, h, sq), NEG_INF, dtype=torch.float32,
                       device=qt.device))


class _RingFlash(torch.autograd.Function):
    """The flash ring over ``group``: ``(o [B,Sq,H,D], lse [B,H,Sq])``,
    differentiable in q, k and v (lse carries no gradient)."""

    @staticmethod
    def forward(ctx, q, k, v, group, causal, sm_scale, softcap):
        idx, n = _rank_and_size(group)
        qt = q.transpose(1, 2).contiguous()
        kt = k.transpose(1, 2).contiguous()
        vt = v.transpose(1, 2).contiguous()
        o_acc, lse = _fwd_init(qt)
        k_c, v_c = kt, vt
        for t in range(n):
            o_acc, lse = ring_fwd_step(qt, k_c, v_c, o_acc, lse, idx=idx,
                                       t=t, n=n, causal=causal,
                                       sm_scale=sm_scale, softcap=softcap)
            if t < n - 1:
                k_c, v_c = ring_shift([k_c, v_c], group)
        ot = o_acc.to(q.dtype)
        ctx.save_for_backward(qt, kt, vt, ot, lse)
        ctx.args = (group, causal, sm_scale, softcap)
        ctx.mark_non_differentiable(lse)
        return ot.transpose(1, 2), lse

    @staticmethod
    def backward(ctx, do, _dlse):
        qt, kt, vt, ot, lse = ctx.saved_tensors
        group, causal, sm_scale, softcap = ctx.args
        idx, n = _rank_and_size(group)
        dot = do.transpose(1, 2).contiguous().to(ot.dtype)
        delta = _delta(ot, dot)
        dq = torch.zeros(qt.shape, dtype=torch.float32, device=qt.device)
        dk = torch.zeros(kt.shape, dtype=torch.float32, device=kt.device)
        dv = torch.zeros_like(dk)
        k_c, v_c = kt, vt
        for t in range(n):
            dq, dk, dv = ring_bwd_step(
                qt, k_c, v_c, dot, lse, delta, dq, dk, dv, idx=idx, t=t,
                n=n, causal=causal, sm_scale=sm_scale, softcap=softcap)
            # The accumulators travel with their part: n shifts bring
            # each home. K/V need no shift after the last step.
            if n > 1:
                if t < n - 1:
                    k_c, v_c, dk, dv = ring_shift([k_c, v_c, dk, dv], group)
                else:
                    dk, dv = ring_shift([dk, dv], group)
        return (dq.to(qt.dtype).transpose(1, 2),
                dk.to(kt.dtype).transpose(1, 2),
                dv.to(vt.dtype).transpose(1, 2), None, None, None, None)


def ring_flash_attention(q, k, v, group, *, causal: bool = True,
                         sm_scale: Optional[float] = None,
                         logits_softcap: Optional[float] = None):
    """The flash ring: ``(o [B,Sq,H,D], lse [B,H,Sq])`` for this rank's
    queries over the whole ring-distributed sequence."""
    scale = sm_scale if sm_scale is not None else q.shape[-1] ** -0.5
    return _RingFlash.apply(q, k, v, group, causal, float(scale),
                            logits_softcap)


def ring_attention(
    q: torch.Tensor,                  # [B, S_local, H, D] (seq part)
    k: torch.Tensor,                  # [B, S_local, K, D]
    v: torch.Tensor,                  # [B, S_local, K, D]
    group=None,
    *,
    causal: bool = True,
    sm_scale: Optional[float] = None,
    logits_softcap: Optional[float] = None,
    impl: str = "auto",
) -> torch.Tensor:
    """Exact attention over the whole ring-distributed sequence; rank
    ``idx`` of ``group`` holds part ``idx`` (None: one rank).

    ``impl``: "pallas" runs the flash kernels per K/V part (their plain
    versions on CPU tensors); "xla" is the online-softmax oracle; "auto"
    picks "pallas" for a CUDA tensor and "xla" on the CPU."""
    if impl == "auto":
        impl = "pallas" if q.device.type == "cuda" else "xla"
    if impl == "pallas":
        return ring_flash_attention(q, k, v, group, causal=causal,
                                    sm_scale=sm_scale,
                                    logits_softcap=logits_softcap)[0]
    if impl != "xla":
        raise ValueError(f"unknown ring attention impl {impl!r}")
    idx, n = _rank_and_size(group)
    b, s_local, h, d = q.shape
    # The ring rotates the raw [B,S,K,D] parts; GQA expands per step.
    n_rep = h // k.shape[2]
    scale = sm_scale if sm_scale is not None else d ** -0.5
    m = torch.full((b, h, s_local), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, h, s_local), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, s_local, h, d), dtype=torch.float32,
                      device=q.device)
    k_cur, v_cur = k, v
    for t in range(n):
        part = (idx - t) % n
        m, l, acc = _block_attn_step(
            q, _repeat_kv(k_cur, n_rep), _repeat_kv(v_cur, n_rep), m, l,
            acc, q_start=idx * s_local, kv_start=part * s_local,
            causal=causal, sm_scale=scale, softcap=logits_softcap)
        if t < n - 1:
            k_cur, v_cur = rotate(group, k_cur, v_cur)
    l_t = l.transpose(1, 2)[..., None]
    out = acc / torch.where(l_t == 0.0, torch.ones_like(l_t), l_t)
    return out.to(q.dtype)


def ulysses_attention(
    q: torch.Tensor,                  # [B, S_local, H, D]
    k: torch.Tensor,                  # [B, S_local, K, D]
    v: torch.Tensor,                  # [B, S_local, K, D]
    group=None,
    *,
    causal: bool = True,
    sm_scale: Optional[float] = None,
    logits_softcap: Optional[float] = None,
    impl: str = "xla",
) -> torch.Tensor:
    """All-to-all swap of the sequence split for a head split, local full
    attention (``multi_head_attention`` with ``impl``; like JAX's, it takes
    the default scale), and the swap back."""
    _, n = _rank_and_size(group)
    h, kh = q.shape[2], k.shape[2]
    if h % n or kh % n:
        raise ValueError(
            f"ulysses needs heads divisible by the seq axis: H={h}, K={kh}, "
            f"axis={n} (use ring attention otherwise)")
    if n == 1:
        return multi_head_attention(q, k, v, causal=causal,
                                    logits_softcap=logits_softcap, impl=impl)
    # [B, S/n, H, D] -> [B, S, H/n, D]
    qh, kh_, vh = (all_to_all(x, group, 2, 1) for x in (q, k, v))
    out = multi_head_attention(qh, kh_, vh, causal=causal,
                               logits_softcap=logits_softcap, impl=impl)
    # [B, S, H/n, D] -> [B, S/n, H, D]
    return all_to_all(out, group, 1, 2)


def _seq_group(mesh, axis_name: str):
    from kubeflow_tpu_torch.parallel.sharding import mesh_shape

    return mesh.get_group(axis_name) if mesh_shape(mesh).get(
        axis_name, 1) > 1 else None


def ring_attention_sharded(q, k, v, mesh, *, axis_name: str = "seq",
                           causal: bool = True,
                           sm_scale: Optional[float] = None,
                           logits_softcap: Optional[float] = None,
                           impl: str = "auto") -> torch.Tensor:
    """``ring_attention`` over the mesh's ``axis_name`` group, on this
    rank's block (its batch rows and sequence part)."""
    return ring_attention(q, k, v, _seq_group(mesh, axis_name),
                          causal=causal, sm_scale=sm_scale,
                          logits_softcap=logits_softcap, impl=impl)


def ulysses_attention_sharded(q, k, v, mesh, *, axis_name: str = "seq",
                              causal: bool = True,
                              sm_scale: Optional[float] = None,
                              logits_softcap: Optional[float] = None,
                              impl: str = "xla") -> torch.Tensor:
    return ulysses_attention(q, k, v, _seq_group(mesh, axis_name),
                             causal=causal, sm_scale=sm_scale,
                             logits_softcap=logits_softcap, impl=impl)


def ring_flash_lockstep(q, k, v, n: int, *, causal: bool = True,
                        sm_scale: Optional[float] = None,
                        softcap: Optional[float] = None, do=None):
    """``n`` ranks of the flash ring driven in lockstep in one process, on
    the whole sequence split into ``n`` parts: the same step functions as
    the distributed ring, with the rotation a shift of a list. q [B,S,H,D],
    k/v [B,S,K,D]; returns ``(o, lse)`` over the whole sequence (o in q's
    layout and dtype, lse [B,H,S]) and, with the output cotangent ``do``,
    ``(dq, dk, dv)`` too."""
    scale = float(sm_scale if sm_scale is not None else q.shape[-1] ** -0.5)
    kw = dict(n=n, causal=causal, sm_scale=scale, softcap=softcap)
    qs = [x.transpose(1, 2).contiguous() for x in q.chunk(n, dim=1)]
    ks = [x.transpose(1, 2).contiguous() for x in k.chunk(n, dim=1)]
    vs = [x.transpose(1, 2).contiguous() for x in v.chunk(n, dim=1)]
    acc = [_fwd_init(qt) for qt in qs]
    held = list(range(n))                # the K/V part each rank holds
    for t in range(n):
        for i in range(n):
            acc[i] = ring_fwd_step(qs[i], ks[held[i]], vs[held[i]], *acc[i],
                                   idx=i, t=t, **kw)
        held = held[-1:] + held[:-1]     # rank i receives rank i-1's part
    ots = [o.to(q.dtype) for o, _ in acc]
    lses = [lse for _, lse in acc]
    o = torch.cat(ots, dim=2).transpose(1, 2)
    lse = torch.cat(lses, dim=2)
    if do is None:
        return o, lse
    dots = [x.transpose(1, 2).contiguous().to(q.dtype)
            for x in do.chunk(n, dim=1)]
    deltas = [_delta(ot, dt) for ot, dt in zip(ots, dots)]
    dq = [torch.zeros(qt.shape, dtype=torch.float32, device=q.device)
          for qt in qs]
    dk = [torch.zeros(kt.shape, dtype=torch.float32, device=q.device)
          for kt in ks]
    dv = [torch.zeros_like(x) for x in dk]
    held = list(range(n))
    for t in range(n):
        for i in range(n):
            j = held[i]
            dq[i], dk[j], dv[j] = ring_bwd_step(
                qs[i], ks[j], vs[j], dots[i], lses[i], deltas[i], dq[i],
                dk[j], dv[j], idx=i, t=t, **kw)
        held = held[-1:] + held[:-1]

    def whole(parts, like):
        return torch.cat([p.to(like.dtype) for p in parts],
                         dim=2).transpose(1, 2)

    return o, lse, (whole(dq, q), whole(dk, k), whole(dv, v))
