"""int8 quantization for serving (port of
``kubeflow_tpu/ops/quantization.py``): weight-only int8 for the decoder's
big matmuls, and the paged pool's int8 KV.

**Weights.** Per-output-channel symmetric int8: for a weight W with
contraction dims C, ``scale = max(amax(|W|, C), 1e-8) / 127`` (fp32,
keepdims) and ``q = clip(round(W / scale), -127, 127)``. A
``QuantizedTensor`` holds both and stands in for the weight in the param
tree; every read of a weight goes through ``models/layers.weight``, which
dequantizes it into the consuming product's operand in the activation
dtype. The products stay plain PyTorch matmuls (the JAX package computes
them outside any Pallas kernel, letting XLA fuse the dequant into the
operand load).

**KV.** Symmetric int8 per token and per head: the scale is taken over
head_dim, computed at write time so each token's own range sets it. The
paged-decode kernel dequantizes in registers as ``k * ks[..., None]``; the
gather path and the chunk prefill dequantize with ``dequantize_kv``.

Values round half to even (``torch.round``, as ``jnp.round``) and clip to
+-127 in both.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Optional

import torch


class QuantizedTensor:
    """An int8 weight (``q``, the original shape) and its fp32
    per-output-channel ``scale`` (the original rank, contraction dims
    collapsed to 1). Indexing slices both fields, so a layer view ``[i]``
    of a stacked ``[L, ...]`` weight is the layer's own quantized weight."""

    __slots__ = ("q", "scale")

    def __init__(self, q: torch.Tensor, scale: torch.Tensor):
        self.q = q
        self.scale = scale

    @property
    def shape(self) -> torch.Size:
        return self.q.shape

    @property
    def ndim(self) -> int:
        return self.q.dim()

    def __getitem__(self, idx) -> "QuantizedTensor":
        return QuantizedTensor(self.q[idx], self.scale[idx])

    def dequant(self, dt: torch.dtype) -> torch.Tensor:
        """``q`` and ``scale`` in ``dt``, multiplied in ``dt`` (the JAX
        order). One kernel reads the int8 payload: int8 values are exact in
        every float dtype, so promoting ``q`` inside the product gives the
        bits of ``q.to(dt) * scale.to(dt)``."""
        return self.q * self.scale.to(dt)

    def to(self, device) -> "QuantizedTensor":
        return QuantizedTensor(self.q.to(device), self.scale.to(device))

    def nbytes_packed(self) -> int:
        """Stored bytes: the int8 payload and the scales."""
        return (self.q.numel() * self.q.element_size()
                + self.scale.numel() * self.scale.element_size())


#: Elements of ``w`` that ``quantize_weight`` widens to fp32 at a time.
QUANT_CHUNK = 1 << 26


def quantize_weight(w: torch.Tensor,
                    contraction_dims: tuple[int, ...]) -> QuantizedTensor:
    """Per-output-channel symmetric int8 over ``w``'s non-contraction dims.
    Exact for zero weights; max relative error about 1/254 of the
    channel's amax. Channels are independent, so a weight larger than
    ``QUANT_CHUNK`` elements is packed in slices along its first channel
    dim, bit for bit the whole-tensor result: its fp32 working copy never
    exceeds one slice (an expert's matrix of a stacked MoE leaf)."""
    dims = tuple(contraction_dims)
    free = [d for d in range(w.dim()) if d not in dims and w.shape[d] > 1]
    if w.numel() > QUANT_CHUNK and free:
        d = free[0]
        step = max(1, QUANT_CHUNK // (w.numel() // w.shape[d]))
        q = torch.empty(w.shape, dtype=torch.int8, device=w.device)
        scale = torch.empty([1 if i in dims else n
                             for i, n in enumerate(w.shape)],
                            dtype=torch.float32, device=w.device)
        for s0 in range(0, w.shape[d], step):
            n = min(step, w.shape[d] - s0)
            part = quantize_weight(w.narrow(d, s0, n), dims)
            q.narrow(d, s0, n).copy_(part.q)
            scale.narrow(d, s0, n).copy_(part.scale)
        return QuantizedTensor(q, scale)
    wf = w.to(torch.float32, copy=True)
    amax = wf.abs().amax(dim=contraction_dims, keepdim=True)
    scale = torch.clamp(amax, min=1e-8) / 127.0
    q = wf.div_(scale).round_().clamp_(-127, 127).to(torch.int8)
    return QuantizedTensor(q, scale)


# Contraction dims per decoder weight, unstacked (models/layers.py shapes):
#   attention: wq/wk/wv [d,h,k] contract d; wo [h,k,d] contracts (h,k)
#   mlp: gate/up [d,m] contract d; down [m,d] contracts m
#   moe: gate/up [e,d,m] contract d (per-expert channels); down [e,m,d]: m
#   lm_head [d,v] contracts d
_CONTRACTIONS = {
    ("attn", "wq"): (0,), ("attn", "wk"): (0,), ("attn", "wv"): (0,),
    ("attn", "wo"): (0, 1),
}
_MLP_DENSE = {"gate": (0,), "up": (0,), "down": (0,)}
_MLP_MOE = {"gate": (1,), "up": (1,), "down": (1,)}


def contraction_dims(path: tuple, cfg) -> Optional[tuple[int, ...]]:
    """The contraction dims of the leaf at ``path`` (keys from the root of
    a decoder param tree; ``layers`` leaves are stacked ``[L, ...]``, so
    their dims shift right by one), or None for a leaf that stays in its
    load dtype (embed, norms, the MoE router: a gather, element-wise ops,
    and a tiny routing-critical [d, E])."""
    if path == ("lm_head",):
        return (0,)
    if len(path) != 3 or path[0] != "layers":
        return None
    _, block, name = path
    if block == "attn":
        dims = _CONTRACTIONS.get(("attn", name))
    elif block == "mlp":
        dims = (_MLP_MOE if cfg.is_moe else _MLP_DENSE).get(name)
    else:
        dims = None
    return None if dims is None else tuple(d + 1 for d in dims)


def check_quantize(quantize: Optional[str]) -> None:
    """Raise on a ``quantize`` setting other than None or "int8"."""
    if quantize not in (None, "int8"):
        raise ValueError(f"unknown quantize {quantize!r}; supported: int8")


def quantize_leaf(path: tuple, leaf: Any, cfg) -> Any:
    """``leaf`` quantized if ``path`` names a quantized weight (and it is
    not one already), else as it is."""
    dims = contraction_dims(path, cfg)
    if dims is None or isinstance(leaf, QuantizedTensor):
        return leaf
    return quantize_weight(leaf, dims)


def quantize_params_int8(params: dict, cfg) -> dict:
    """The big matmul weights of a decoder param tree (the port's stacked
    ``[L, ...]`` layout) quantized to int8: attention wq/wk/wv/wo, the MLP
    or expert gate/up/down, and an untied lm_head. A leaf that is already
    a ``QuantizedTensor`` stays as it is."""
    return _map_with_path(lambda path, leaf: quantize_leaf(path, leaf, cfg),
                          params)


def _map_with_path(fn: Callable, tree: Any, path: tuple = ()) -> Any:
    """``fn(path, leaf)`` over every leaf of a nested dict; same keys."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    return fn(path, tree)


def packed_param_bytes_estimate(cfg) -> int:
    """``packed_param_bytes`` from the config alone (the repository's
    estimate for an engine not built yet): the leaves
    ``quantize_params_int8`` packs at 1 byte per parameter plus fp32
    per-output-channel scales, everything else (embed, norms, the MoE
    router) at the weight dtype."""
    itemsize = cfg.weight_dtype.itemsize
    n = cfg.n_layers
    h, q_out = cfg.hidden, cfg.n_heads * cfg.head_dim
    kv_out = cfg.n_kv_heads * cfg.head_dim
    quant = n * (h * q_out + 2 * h * kv_out + q_out * h)
    scales = n * (q_out + 2 * kv_out + h)
    experts = cfg.num_experts if cfg.is_moe else 1
    quant += n * experts * 3 * h * cfg.mlp_dim
    scales += n * experts * (2 * cfg.mlp_dim + h)
    if not cfg.tie_embeddings:
        quant += h * cfg.vocab_size
        scales += cfg.vocab_size
    other = max(cfg.num_params() - quant, 0)
    return quant + scales * 4 + other * itemsize


def packed_param_bytes(params: Any) -> int:
    """Stored parameter bytes of a param tree, quantized leaves at their
    packed size."""
    if isinstance(params, dict):
        return sum(packed_param_bytes(v) for v in params.values())
    if isinstance(params, QuantizedTensor):
        return params.nbytes_packed()
    return math.prod(params.shape) * params.element_size()


# -- KV cache quantization (paged pool) ----------------------------------------

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


# -- quality gate --------------------------------------------------------------

def quantization_quality(cfg, params_ref: dict, params_q: dict, prompts, *,
                         max_new: int = 16) -> dict:
    """Greedy-token match rate and mean |Δlogprob| of the reference's
    chosen tokens, quantized against reference params, over a fixed prompt
    set, teacher-forced on the reference's greedy path (both forwards see
    the same context at every step). Plain full forwards, no engine."""
    from kubeflow_tpu_torch.models.decoder import decoder_forward

    dev = params_ref["embed"].device
    matches = total = 0
    deltas = []
    with torch.no_grad():
        for prompt in prompts:
            seq = list(prompt)
            for _ in range(max_new):
                t = torch.tensor([seq], dtype=torch.int64, device=dev)
                logits_ref, _ = decoder_forward(params_ref, t, cfg)
                logits_q, _ = decoder_forward(params_q, t, cfg)
                lr = torch.log_softmax(logits_ref[0, -1].float(), dim=-1)
                lq = torch.log_softmax(logits_q[0, -1].float(), dim=-1)
                choice = int(torch.argmax(lr))
                deltas.append(float(torch.abs(lq[choice] - lr[choice])))
                matches += int(choice == int(torch.argmax(lq)))
                total += 1
                seq.append(choice)
    return {
        "greedy_match_rate": matches / max(total, 1),
        "mean_abs_logprob_delta": sum(deltas) / max(len(deltas), 1),
        "tokens_compared": total,
    }
