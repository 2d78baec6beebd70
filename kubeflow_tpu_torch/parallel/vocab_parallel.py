"""Megatron's vocab-parallel cross-entropy over the ``model`` axis.

Each rank holds the head's columns ``[v0, v0 + V/tp)`` (or its part of a
whole head whose vocabulary does not divide, ``collectives.part``). Per
row it computes its shard's lse, picked logit, row max and correct
(``fused_xent.shard_stats`` on kernel 9 with the targets shifted by
``v0``, where a target outside the shard picks nothing; ``logit_stats``
on logits); one all-gather brings every rank's rows, and
``combine_shards`` turns them into the whole vocabulary's nll, lse and
correct (argmax ties to the lowest index: the first shard holding the
row's largest logit decides). The backward runs kernels 10 and 11 on the
local columns with the global lse: ``d_head`` stays local and
``d_hidden`` is this rank's part, summed over the axis by
``copy_to_model``'s backward.

``fused_ce`` is the fused branch of ``decoder_loss`` (kernels 9–11),
``vocab_parallel_ce`` the dense and chunked ones (on logits), and
``vocab_parallel_lockstep`` runs a model axis's shards one after another
in one process, with no group.
"""

from __future__ import annotations

from typing import Optional

import torch

from kubeflow_tpu_torch.ops import fused_xent
from kubeflow_tpu_torch.parallel import collectives as C


def logit_stats(logits: torch.Tensor, t_local: torch.Tensor) -> torch.Tensor:
    """``fused_xent.shard_stats`` of a shard's logits [N, Vs] (the plain
    form)."""
    lse = torch.logsumexp(logits, dim=-1)
    picked = (logits * fused_xent._onehot(t_local, logits.shape[1])).sum(
        dim=-1)
    correct = (logits.argmax(dim=-1) == t_local).float()
    return torch.stack([lse, picked, logits.amax(dim=-1), correct])


def combine_shards(stats: torch.Tensor):
    """The shards' ``[n, 4, T]`` statistics, in shard order, → the whole
    vocabulary's (nll, lse, correct), each fp32 [T]: the lse's logsumexp,
    the picked logits' sum (one shard holds the target), and the correct
    flag of the first shard that holds the row's largest logit (argmax
    ties go to the lowest index)."""
    lse_s, picked_s, max_s, correct_s = stats.unbind(1)
    lse = torch.logsumexp(lse_s, dim=0)
    first = (max_s == max_s.amax(dim=0)).int().argmax(dim=0)
    correct = torch.gather(correct_s, 0, first[None])[0]
    return lse - picked_s.sum(dim=0), lse, correct


def _all_shards(stats: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``[4, T]`` statistics over ``group``: ``[n, 4, T]``."""
    import torch.distributed as dist

    n = C.group_size(group)
    out = stats.new_empty((n * stats.shape[0], stats.shape[1]))
    dist.all_gather_into_tensor(out, stats.contiguous(), group=group)
    return out.reshape(n, *stats.shape)


class VocabParallelCEFn(torch.autograd.Function):
    """``apply(h2 [T, D], w [D, V/tp], t_local [T] int32, softcap, group)``
    → ``(nll, correct)`` over the whole vocabulary; kernels 9–11 on the
    rank's columns. ``d_hidden`` is this rank's part."""

    @staticmethod
    def forward(ctx, h2, w, t, softcap, group):
        nll, lse, correct = combine_shards(_all_shards(
            fused_xent.shard_stats(h2, w, t, softcap), group))
        ctx.save_for_backward(h2, w, t, lse)
        ctx.softcap = softcap
        ctx.mark_non_differentiable(correct)
        return nll, correct

    @staticmethod
    def backward(ctx, dnll, _dcorrect):
        h2, w, t, lse = ctx.saved_tensors
        dh, dw = fused_xent.xent_bwd(h2, w, t, lse,
                                     dnll.float().contiguous(), ctx.softcap)
        return dh, dw, None, None, None


def fused_ce(hidden: torch.Tensor, head: torch.Tensor,
             targets: torch.Tensor, tp, *,
             logits_softcap: Optional[float] = None,
             offset: Optional[int] = None):
    """``fused_xent.fused_cross_entropy`` with ``head`` this rank's vocab
    columns ``[D, V/tp]`` of the model axis ``tp`` (from ``offset``, by
    default ``rank · V/tp``; a vocabulary that does not divide gives the
    ranks parts of unequal widths); ``hidden`` is whole on every rank.
    ``(nll, correct)``, fp32 with ``targets``' shape."""
    d = hidden.shape[-1]
    if head.dim() != 2 or head.shape[0] != d:
        raise ValueError(f"head {tuple(head.shape)} does not match hidden "
                         f"dim {d}")
    h2 = C.copy_to_model(hidden, tp).reshape(-1, d).contiguous()
    v0 = tp.rank * head.shape[1] if offset is None else offset
    local = (targets.reshape(-1) - v0).to(
        torch.int32).contiguous()
    nll, correct = VocabParallelCEFn.apply(
        h2, head.contiguous(), local,
        None if logits_softcap is None else float(logits_softcap), tp.group)
    return nll.reshape(targets.shape), correct.reshape(targets.shape)


class _VocabParallelLogitsCE(torch.autograd.Function):
    """The plain vocab-parallel CE on a rank's fp32 logits [N, V/tp]."""

    @staticmethod
    def forward(ctx, logits, t_local, group):
        nll, lse, correct = combine_shards(_all_shards(
            logit_stats(logits, t_local), group))
        ctx.save_for_backward(logits, t_local, lse)
        ctx.mark_non_differentiable(correct)
        return nll, correct

    @staticmethod
    def backward(ctx, dnll, _dcorrect):
        logits, t, lse = ctx.saved_tensors
        dl = torch.exp(logits - lse[:, None])
        dl.sub_(fused_xent._onehot(t, logits.shape[1])).mul_(
            dnll.float()[:, None])
        return dl, None, None


def vocab_parallel_ce(logits: torch.Tensor, targets: torch.Tensor, tp,
                      offset: Optional[int] = None):
    """``(nll, correct)``, fp32 with ``targets``' shape, from this rank's
    logits ``[..., V/tp]`` (columns ``[offset, ...)`` of the vocabulary,
    by default ``rank · V/tp``) and the global ``targets``: local
    statistics, all-gathered over the axis and combined
    (``combine_shards``)."""
    v = logits.shape[-1]
    local = (targets.reshape(-1) - (tp.rank * v if offset is None
                                    else offset)).long()
    nll, correct = _VocabParallelLogitsCE.apply(
        logits.reshape(-1, v).float(), local, tp.group)
    return nll.reshape(targets.shape), correct.reshape(targets.shape)


def vocab_parallel_lockstep(h2: torch.Tensor, w: torch.Tensor,
                            t: torch.Tensor, shards: int,
                            softcap: Optional[float] = None,
                            g: Optional[torch.Tensor] = None):
    """The vocab-parallel fused CE of ``shards`` ranks run one after
    another in this process (no group): each shard's forward on its
    columns, the combine, then each shard's backward with the global lse
    and the cotangent ``g`` (default ones). Returns ``(nll, lse, correct,
    d_hidden, d_head)``: d_hidden summed over the shards, d_head their
    columns side by side — what the ranks of a model axis compute."""
    v = w.shape[1] // shards
    parts = [w[:, r * v:(r + 1) * v].contiguous() for r in range(shards)]
    local = [(t.long() - r * v).to(torch.int32).contiguous()
             for r in range(shards)]
    nll, lse, correct = combine_shards(torch.stack([
        fused_xent.shard_stats(h2, p, lt, softcap)
        for p, lt in zip(parts, local)]))
    g = torch.ones_like(nll) if g is None else g.float().contiguous()
    dh, dws = None, []
    for p, lt in zip(parts, local):
        dhr, dwr = fused_xent.xent_bwd(h2, p, lt, lse, g, softcap)
        dh = dhr.float() if dh is None else dh + dhr.float()
        dws.append(dwr)
    return nll, lse, correct, dh.to(h2.dtype), torch.cat(dws, dim=1)
