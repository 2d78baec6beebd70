"""KV-cache quantization for the paged pool — the KV half of
``kubeflow_tpu/ops/quantization.py`` (weight quantization arrives with the
int8 slice).

Symmetric int8 per token and per head: the scale is taken over head_dim
(``max(amax, 1e-8) / 127``, computed at write time so each token's own
range sets it), values round half to even (``torch.round``, as
``jnp.round``) and clip to +-127. The paged-decode kernel dequantizes in
registers as ``k * ks[..., None]``; the gather path and the chunk prefill
dequantize with ``dequantize_kv``.
"""

from __future__ import annotations

import torch


def quantize_kv(x: torch.Tensor, *, axis: int = -1):
    """Returns (q int8, scale f32 with ``axis`` removed)."""
    xf = x.float()
    amax = xf.abs().amax(dim=axis)
    scale = torch.clamp(amax, min=1e-8) / 127.0
    q = torch.clamp(torch.round(xf / scale.unsqueeze(axis)), -127, 127)
    return q.to(torch.int8), scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor, dt: torch.dtype,
                  *, axis: int = -1) -> torch.Tensor:
    """``q`` and ``scale`` cast to ``dt`` and multiplied (in ``dt``, as the
    JAX package does)."""
    return q.to(dt) * scale.unsqueeze(axis).to(dt)
