"""Decoder model configuration + the preset zoo (port of
``kubeflow_tpu/models/config.py``, field for field; dtype names map to
``torch`` dtypes through ``activation_dtype``/``weight_dtype``)."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    """A dtype name as the config spells it (``"bfloat16"``) → torch dtype."""
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unknown dtype {name!r}; one of {sorted(_DTYPES)}")


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    """Hashable decoder architecture description."""

    vocab_size: int = 32000
    hidden: int = 512
    n_layers: int = 4
    n_heads: int = 8
    n_kv_heads: int = 8            # < n_heads => GQA
    head_dim: int = 64
    mlp_dim: int = 1408
    max_seq_len: int = 2048
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    hidden_act: str = "silu"       # silu => SwiGLU; gelu => GeGLU (gemma)
    tie_embeddings: bool = False
    norm_plus_one: bool = False    # gemma-style (1 + w) RMSNorm weight
    embed_scale: bool = False      # gemma-style sqrt(hidden) embedding scale
    logits_softcap: Optional[float] = None   # gemma-2 style tanh softcap
    # MoE (0 => dense). The port's MoE block arrives with a later slice.
    num_experts: int = 0
    experts_per_token: int = 2
    moe_impl: str = "dispatch"
    capacity_factor: float = 1.25
    # Training-time policy fields, kept so configs round-trip unchanged; the
    # forward-only serving slice reads none of them.
    scan_layers: bool = True
    remat_policy: str = "nothing_saveable"
    pipeline_schedule: str = "gpipe"
    loss_chunk_size: int = 0
    # Hand-written kernels for the norm / SwiGLU / prefill-attention ops:
    # "auto" = kernels on a CUDA tensor, plain torch on the CPU; "on" routes
    # every call through the kernel wrappers (which take the plain version
    # only for a CPU tensor); "off" keeps the plain torch ops.
    fused_kernels: str = "auto"
    dtype: str = "bfloat16"        # activation/compute dtype
    param_dtype: str = "float32"

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def activation_dtype(self) -> torch.dtype:
        return torch_dtype(self.dtype)

    @property
    def weight_dtype(self) -> torch.dtype:
        return torch_dtype(self.param_dtype)

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    def num_params(self) -> int:
        """Parameter count (embedding included once if tied)."""
        d, v = self.hidden, self.vocab_size
        attn = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
        if self.is_moe:
            mlp = self.num_experts * 3 * d * self.mlp_dim + d * self.num_experts
        else:
            mlp = 3 * d * self.mlp_dim
        norms = 2 * d
        per_layer = attn + mlp + norms
        embed = v * d if self.tie_embeddings else 2 * v * d
        return self.n_layers * per_layer + embed + d

    def flops_per_token(self) -> float:
        """Approximate training FLOPs/token (fwd+bwd ≈ 6N for dense; MoE
        counts only active experts)."""
        d = self.hidden
        attn = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
        mlp_active = (self.experts_per_token if self.is_moe else 1) * 3 * d * self.mlp_dim
        dense_n = self.n_layers * (attn + mlp_active) + self.vocab_size * d
        return 6.0 * dense_n


PRESETS: dict[str, DecoderConfig] = {
    # Llama-3-8B (public card: 32L, 4096h, 32 heads / 8 kv, 14336 mlp, 128k vocab)
    "llama3-8b": DecoderConfig(
        vocab_size=128256, hidden=4096, n_layers=32, n_heads=32, n_kv_heads=8,
        head_dim=128, mlp_dim=14336, max_seq_len=8192, rope_theta=500000.0,
        loss_chunk_size=512,
    ),
    # Llama-3-70B-class (for sharding dry-runs only)
    "llama3-70b": DecoderConfig(
        vocab_size=128256, hidden=8192, n_layers=80, n_heads=64, n_kv_heads=8,
        head_dim=128, mlp_dim=28672, max_seq_len=8192, rope_theta=500000.0,
        loss_chunk_size=512,
    ),
    # Gemma-2B (public card: 18L, 2048h, 8 heads / 1 kv, head_dim 256, gelu,
    # 256k vocab, tied embeddings, embedding scale, (1+w) norms)
    "gemma-2b": DecoderConfig(
        vocab_size=256128, hidden=2048, n_layers=18, n_heads=8, n_kv_heads=1,
        head_dim=256, mlp_dim=16384, max_seq_len=8192, rope_theta=10000.0,
        hidden_act="gelu", tie_embeddings=True, norm_plus_one=True,
        embed_scale=True, loss_chunk_size=512,
    ),
    # Mixtral-8x7B (public card: 32L, 4096h, 32/8 heads, 14336 mlp, 8 experts top-2)
    "mixtral-8x7b": DecoderConfig(
        vocab_size=32000, hidden=4096, n_layers=32, n_heads=32, n_kv_heads=8,
        head_dim=128, mlp_dim=14336, max_seq_len=8192, rope_theta=1000000.0,
        num_experts=8, experts_per_token=2,
    ),
    # tiny variants for tests (structure-faithful, sized for one CPU core)
    "tiny": DecoderConfig(
        vocab_size=256, hidden=64, n_layers=2, n_heads=4, n_kv_heads=2,
        head_dim=16, mlp_dim=128, max_seq_len=128,
    ),
    "tiny-gemma": DecoderConfig(
        vocab_size=256, hidden=64, n_layers=2, n_heads=4, n_kv_heads=1,
        head_dim=16, mlp_dim=128, max_seq_len=128, hidden_act="gelu",
        tie_embeddings=True, norm_plus_one=True, embed_scale=True,
        logits_softcap=30.0,
    ),
    "tiny-moe": DecoderConfig(
        vocab_size=256, hidden=64, n_layers=2, n_heads=4, n_kv_heads=2,
        head_dim=16, mlp_dim=128, max_seq_len=128,
        num_experts=4, experts_per_token=2,
    ),
}


def preset(name: str, **overrides) -> DecoderConfig:
    if name not in PRESETS:
        raise KeyError(f"unknown model preset {name!r}; known: {sorted(PRESETS)}")
    cfg = PRESETS[name]
    return dataclasses.replace(cfg, **overrides) if overrides else cfg
