"""Attention ops: the plain torch implementation + impl dispatch (port of
``kubeflow_tpu/ops/attention.py``).

The plain path (``impl="xla"``, the JAX package's name for it) is the
numerics reference: fp32 scores and softmax whatever the activation dtype,
probabilities cast to v's dtype for the PV product. ``impl="pallas"``
dispatches to the port's hand-written flash kernel
(``ops/flash_attention.py``).
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """[B,S,K,D] -> [B,S,K*n_rep,D] for GQA (each kv head serves n_rep q heads)."""
    if n_rep == 1:
        return k
    b, s, h, d = k.shape
    return k[:, :, :, None, :].expand(b, s, h, n_rep, d).reshape(
        b, s, h * n_rep, d)


def causal_mask(q_len: int, kv_len: int, *, q_offset: int = 0,
                device=None) -> torch.Tensor:
    """[q_len, kv_len] boolean mask; True = attend. ``q_offset`` is the
    absolute position of query 0 (for decode with a KV cache)."""
    q_pos = torch.arange(q_len, device=device)[:, None] + q_offset
    kv_pos = torch.arange(kv_len, device=device)[None, :]
    return kv_pos <= q_pos


def multi_head_attention(
    q: torch.Tensor,                  # [B, Sq, H, D]
    k: torch.Tensor,                  # [B, Skv, K, D]
    v: torch.Tensor,                  # [B, Skv, K, D]
    *,
    mask: Optional[torch.Tensor] = None,  # broadcastable to [B,H,Sq,Skv]; True=attend
    causal: bool = True,
    q_offset: int = 0,
    logits_softcap: Optional[float] = None,
    impl: str = "xla",
) -> torch.Tensor:
    """Scaled dot-product attention with GQA. Returns [B, Sq, H, D]."""
    if impl == "pallas":
        if mask is not None:
            raise ValueError("impl='pallas' takes no explicit mask")
        from kubeflow_tpu_torch.ops.flash_attention import flash_attention

        return flash_attention(q, k, v, causal=causal, q_offset=q_offset,
                               logits_softcap=logits_softcap)[0]
    if impl != "xla":
        raise ValueError(f"unknown attention impl {impl!r}")

    b, sq, h, d = q.shape
    _, skv, kh, _ = k.shape
    n_rep = h // kh
    k = _repeat_kv(k, n_rep)
    v = _repeat_kv(v, n_rep)

    scale = d ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    logits = logits * scale
    if logits_softcap is not None:
        logits = torch.tanh(logits / logits_softcap) * logits_softcap
    if causal:
        cmask = causal_mask(sq, skv, q_offset=q_offset, device=q.device)
        logits = logits.masked_fill(~cmask[None, None, :, :], NEG_INF)
    if mask is not None:
        logits = logits.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)
