"""Vision models: the ViT encoder and the CLIP dual encoder (port of
``kubeflow_tpu/models/vision.py``).

Params keep the JAX package's keys and layouts, so
``models/convert.py::params_from_jax`` carries a JAX vision tree across:
``patch_embed [P²C, D]``, ``pos_embed [S, D]``, ``cls_token [D]``,
``head [D, classes]``, ``final_ln {scale, bias}``, and the encoder blocks
stacked on a leading ``[L, ...]`` axis: ``ln1``/``ln2 {scale, bias}``,
``wqkv [D, 3, H, Dh]``, ``wo [H, Dh, D]``, ``w1 [D, M]``, ``b1 [M]``,
``w2 [M, D]``, ``b2 [D]``; CLIP's ``image`` (a ViT tree), ``text``
(``embed``, ``pos_embed``, ``layers``, ``final_ln``), ``img_proj``,
``txt_proj`` and ``logit_scale``. Random weights come from a
``torch.Generator`` with the JAX package's fan-in scales; the values
differ from ``jax.random``'s.

Compute follows the JAX dtype policy: products in the activation dtype,
layer norms, softmax and the losses in fp32, the ViT head's product
widened to fp32 (the JAX ``preferred_element_type``). Patchify is a
reshape and one matmul; attention is the plain path
(``ops/attention.py``, the JAX default ``"xla"``): JAX computes the whole
vision model outside any Pallas kernel, so no hand-written kernel runs
here. While autograd records, each encoder block is rematerialized per
``remat_policy`` through ``torch.utils.checkpoint``. ``vit_param_specs``
and ``clip_param_specs`` give every leaf's logical axes (JAX's spec
trees).

Under a mesh (``mesh=``, JAX's argument) each rank holds its shards of
the params and its rows of the batch, and computes what JAX's GSPMD
layout gives it (``VisionAxes``): heads, mlp columns and classes over
``model`` (Megatron's column and row products, one all-reduce after
``wo`` and one after ``w2``), its positions of every sequence over
``seq`` (K and V all-gathered for attention, the pooled features summed
over the axis), the rows over the batch axes (ViT's mean is the global
one, CLIP's contrastive logits span the global batch, the features
all-gathered over the batch ranks). Dims that do not divide are whole on
every rank, as JAX replicates them, and each rank computes its part.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch
from torch.utils.checkpoint import checkpoint

from kubeflow_tpu_torch.models.config import torch_dtype
from kubeflow_tpu_torch.models.decoder import layer_view
from kubeflow_tpu_torch.models.layers import (
    _init, rank_part_of, vocab_rows,
)
from kubeflow_tpu_torch.ops.attention import multi_head_attention
from kubeflow_tpu_torch.parallel import collectives as C
from kubeflow_tpu_torch.parallel import vocab_parallel as VP

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    """Hashable ViT architecture description (the JAX fields)."""

    image_size: int = 224
    patch_size: int = 16
    channels: int = 3
    hidden: int = 1024
    n_layers: int = 24
    n_heads: int = 16
    mlp_dim: int = 4096
    num_classes: int = 1000       # classification head; 0 = feature output
    pool: str = "cls"             # cls | gap
    norm_eps: float = 1e-6
    scan_layers: bool = True
    remat_policy: str = "nothing_saveable"
    dtype: str = "bfloat16"
    param_dtype: str = "float32"

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def seq_len(self) -> int:
        return self.num_patches + (1 if self.pool == "cls" else 0)

    @property
    def head_dim(self) -> int:
        return self.hidden // self.n_heads

    @property
    def activation_dtype(self) -> torch.dtype:
        return torch_dtype(self.dtype)

    @property
    def weight_dtype(self) -> torch.dtype:
        return torch_dtype(self.param_dtype)


VIT_PRESETS: dict[str, ViTConfig] = {
    # Public ViT-L/16 architecture (AN IMAGE IS WORTH 16x16 WORDS table 1).
    "vit-l16": ViTConfig(hidden=1024, n_layers=24, n_heads=16, mlp_dim=4096),
    "vit-b16": ViTConfig(hidden=768, n_layers=12, n_heads=12, mlp_dim=3072),
    "tiny-vit": ViTConfig(image_size=32, patch_size=8, hidden=64, n_layers=2,
                          n_heads=4, mlp_dim=128, num_classes=10),
}


def vit_preset(name: str, **overrides) -> ViTConfig:
    return dataclasses.replace(VIT_PRESETS[name], **overrides)


# -- layers ----------------------------------------------------------------------

def _init_layernorm(cfg: ViTConfig, dim: int, device) -> dict:
    return {"scale": torch.ones((dim,), dtype=cfg.weight_dtype,
                                device=device),
            "bias": torch.zeros((dim,), dtype=cfg.weight_dtype,
                                device=device)}


def _layernorm(p: dict, x: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * p["scale"] + p["bias"]).to(x.dtype)


def _init_encoder_block(gen: torch.Generator, cfg: ViTConfig) -> dict:
    d, h, hd, dt = cfg.hidden, cfg.n_heads, cfg.head_dim, cfg.weight_dtype
    dev = gen.device
    return {
        "ln1": _init_layernorm(cfg, d, dev),
        "ln2": _init_layernorm(cfg, d, dev),
        "wqkv": _init(gen, (d, 3, h, hd), dt),
        "wo": _init(gen, (h, hd, d), dt),
        "w1": _init(gen, (d, cfg.mlp_dim), dt),
        "b1": torch.zeros((cfg.mlp_dim,), dtype=dt, device=dev),
        "w2": _init(gen, (cfg.mlp_dim, d), dt),
        "b2": torch.zeros((d,), dtype=dt, device=dev),
    }


def _stack(blocks: list) -> Any:
    if isinstance(blocks[0], dict):
        return {k: _stack([b[k] for b in blocks]) for k in blocks[0]}
    return torch.stack(blocks)


def _init_layers(gen: torch.Generator, cfg: ViTConfig) -> dict:
    """``n_layers`` blocks drawn in order, stacked on a leading axis."""
    return _stack([_init_encoder_block(gen, cfg)
                   for _ in range(cfg.n_layers)])


def _encoder_block_specs() -> dict:
    """Logical-axis spec tree of one encoder block."""
    norm = {"scale": ("norm",), "bias": ("norm",)}
    return {"ln1": dict(norm), "ln2": dict(norm),
            "wqkv": ("embed", None, "heads", "head_dim"),
            "wo": ("heads", "head_dim", "embed"),
            "w1": ("embed", "mlp"), "b1": ("mlp",),
            "w2": ("mlp", "embed"), "b2": ("norm",)}


def _stacked_specs() -> dict:
    def stack(t):
        if isinstance(t, dict):
            return {k: stack(v) for k, v in t.items()}
        return ("layers",) + t

    return stack(_encoder_block_specs())


def vit_param_specs(cfg: ViTConfig) -> Params:
    """Logical-axis spec tree mirroring ``init_vit_params``."""
    specs: Params = {
        "patch_embed": (None, "embed"),
        "pos_embed": (None, None),
        "layers": _stacked_specs(),
        "final_ln": {"scale": ("norm",), "bias": ("norm",)},
    }
    if cfg.pool == "cls":
        specs["cls_token"] = ("norm",)
    if cfg.num_classes:
        specs["head"] = ("embed", "vocab")
    return specs


# -- the mesh --------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class VisionAxes:
    """Where a vision step's work is split (``vision_axes``), JAX's layout
    of the same mesh:

    - ``tp``: the ``model`` axis. The heads of ``wqkv``/``wo``, the mlp
      columns of ``w1``/``b1``/``w2`` and the ViT head's classes are split
      over it (each rank its ``collectives.part``, read from the whole leaf
      where the dim does not divide, as JAX replicates it): Megatron's
      column products after ``copy_to_model`` and row products summed by
      ``reduce_from_model``; norms and biases after a sum stay whole;
    - ``seq``, ``seq_rank``, ``seq_size``: the ``seq`` axis. Each rank
      holds its positions of every sequence (``span``: ceil-sized parts,
      the last one short, as GSPMD splits a dim that does not divide);
      attention gathers K and V over it;
    - ``batch``: the group of the batch ranks (``dcn``, ``data``,
      ``fsdp``), which hold the other rows;
    - ``copies``: the ranks that compute the same loss on the same rows
      and whose gradients are summed (``seq`` × ``pipeline``: no vision
      leaf names ``pipeline``, so JAX computes those ranks redundantly):
      each rank's loss is 1/copies of it."""

    tp: Optional[C.ModelAxis] = None
    seq: Any = None
    seq_rank: int = 0
    seq_size: int = 1
    batch: Any = None
    copies: int = 1

    def span(self, s: int) -> tuple[int, int]:
        """``[start, stop)`` of this rank's positions of a length-``s``
        sequence."""
        c = -(-s // self.seq_size)
        return min(self.seq_rank * c, s), min((self.seq_rank + 1) * c, s)


def vision_axes(mesh) -> Optional[VisionAxes]:
    """The ``VisionAxes`` of a ``DeviceMesh`` (None without one). The
    groups are made on first use, by every rank in one order."""
    if mesh is None:
        return None
    from kubeflow_tpu_torch.parallel.fsdp import BATCH_AXES
    from kubeflow_tpu_torch.parallel.sharding import mesh_shape

    group, idx, n = C.seq_info(mesh)
    return VisionAxes(C.model_axis(mesh), group, idx, n,
                      C.axis_group(mesh, BATCH_AXES),
                      n * mesh_shape(mesh).get("pipeline", 1))


def _tp(ax: Optional[VisionAxes]):
    return None if ax is None else ax.tp


def gather_seq(t: torch.Tensor, ax: Optional[VisionAxes],
               s: int) -> torch.Tensor:
    """The ranks' positions ``[B, s_r, ...]`` over ``seq`` → the whole
    ``[B, s, ...]``: each part padded to the ceil size and all-gathered
    (reduce-scattered in the backward), the padding dropped."""
    if ax is None or ax.seq_size == 1:
        return t
    c = -(-s // ax.seq_size)
    if t.shape[1] < c:
        t = torch.cat([t, t.new_zeros((t.shape[0], c - t.shape[1],
                                       *t.shape[2:]))], dim=1)
    return C.gather_dim(t, 1, ax.seq)[:, :s]


def seq_sum(t: torch.Tensor, ax: Optional[VisionAxes]) -> torch.Tensor:
    """The ranks' parts of a pooled feature summed over ``seq``, forward
    and backward: every rank computes the loss on the same feature, each
    1/copies of it, so a part's gradient is the sum of theirs."""
    if ax is None or ax.seq_size == 1:
        return t
    return C.copy_to(C.reduce_from(t, ax.seq), ax.seq)


# -- the encoder block -----------------------------------------------------------

def block_qkv(p: dict, h: torch.Tensor, cfg: ViTConfig,
              ax: Optional[VisionAxes] = None):
    """The normed stream ``h`` [B,s,D] → this rank's ``(q, k, v)``
    [B,s,Hl,Dh]: its heads of ``wqkv`` ("bsd,dthk->tbshk" as one matmul
    over the [D, 3·Hl·Dh] view), the input through ``copy_to_model``."""
    dt = cfg.activation_dtype
    b, s, d = h.shape
    w = rank_part_of(p["wqkv"], 2, cfg.n_heads, _tp(ax), "heads")
    qkv = (C.copy_to_model(h, _tp(ax)) @ w.to(dt).reshape(d, -1)).reshape(
        b, s, 3, w.shape[2], cfg.head_dim)
    return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]


def block_attend(p: dict, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 cfg: ViTConfig, ax: Optional[VisionAxes] = None, *,
                 causal: bool = False, q_offset: int = 0) -> torch.Tensor:
    """This rank's queries over the whole sequence's ``k``/``v``, through
    its rows of ``wo``: [B,s,D], a partial sum over the model axis."""
    dt = cfg.activation_dtype
    b, s = q.shape[:2]
    out = multi_head_attention(q, k, v, causal=causal, q_offset=q_offset)
    wo = rank_part_of(p["wo"], 0, cfg.n_heads, _tp(ax), "heads")
    return out.reshape(b, s, -1) @ wo.to(dt).reshape(-1, cfg.hidden)


def block_mlp(p: dict, h: torch.Tensor, cfg: ViTConfig,
              ax: Optional[VisionAxes] = None) -> torch.Tensor:
    """``gelu(h w1 + b1) w2`` on this rank's mlp columns (``b2`` is added
    once, after the sum over the model axis): a partial sum."""
    dt = cfg.activation_dtype
    m = cfg.mlp_dim
    w1 = rank_part_of(p["w1"], 1, m, _tp(ax), "mlp")
    b1 = rank_part_of(p["b1"], 0, m, _tp(ax), "mlp")
    w2 = rank_part_of(p["w2"], 0, m, _tp(ax), "mlp")
    h = torch.nn.functional.gelu(
        C.copy_to_model(h, _tp(ax)) @ w1.to(dt) + b1.to(dt),
        approximate="tanh")
    return h @ w2.to(dt)


def _encoder_block(p: dict, x: torch.Tensor, cfg: ViTConfig, *,
                   causal: bool = False, ax: Optional[VisionAxes] = None,
                   seq_len: Optional[int] = None) -> torch.Tensor:
    """One block on this rank's positions ``x`` [B,s,D] of sequences of
    ``seq_len`` (default ``s``)."""
    dt = cfg.activation_dtype
    tp = _tp(ax)
    s = x.shape[1] if seq_len is None else seq_len
    q, k, v = block_qkv(p, _layernorm(p["ln1"], x, cfg.norm_eps), cfg, ax)
    off = 0 if ax is None or ax.seq_size == 1 else ax.span(s)[0]
    out = block_attend(p, q, gather_seq(k, ax, s), gather_seq(v, ax, s),
                       cfg, ax, causal=causal, q_offset=off)
    x = x + C.reduce_from_model(out, tp)
    h = _layernorm(p["ln2"], x, cfg.norm_eps)
    return x + (C.reduce_from_model(block_mlp(p, h, cfg, ax), tp)
                + p["b2"].to(dt))


def _encode(params: Params, x: torch.Tensor, cfg: ViTConfig, *,
            causal: bool = False, ax: Optional[VisionAxes] = None,
            seq_len: Optional[int] = None) -> torch.Tensor:
    """The shared transformer-encoder trunk over the stacked blocks; each
    block rematerialized per ``cfg.remat_policy`` while autograd records
    (``"none"`` saves everything; any other policy replays the block in
    the backward, as the JAX ``_remat`` does)."""
    remat = torch.is_grad_enabled() and cfg.remat_policy != "none"
    layers = params["layers"]
    for i in range(cfg.n_layers):
        bp = layer_view(layers, i)
        if remat:
            x = checkpoint(lambda x, bp=bp: _encoder_block(
                bp, x, cfg, causal=causal, ax=ax, seq_len=seq_len), x,
                use_reentrant=False)
        else:
            x = _encoder_block(bp, x, cfg, causal=causal, ax=ax,
                               seq_len=seq_len)
    return _layernorm(params["final_ln"], x, cfg.norm_eps)


# -- ViT -------------------------------------------------------------------------

def init_vit_params(gen: torch.Generator, cfg: ViTConfig) -> Params:
    """Random ViT weights from ``gen`` on ``gen``'s device."""
    dt, dev = cfg.weight_dtype, gen.device
    patch_dim = cfg.patch_size * cfg.patch_size * cfg.channels
    params: Params = {
        "patch_embed": _init(gen, (patch_dim, cfg.hidden), dt),
        "pos_embed": _init(gen, (cfg.seq_len, cfg.hidden), dt, scale=0.02),
        "layers": _init_layers(gen, cfg),
        "final_ln": _init_layernorm(cfg, cfg.hidden, dev),
    }
    if cfg.pool == "cls":
        params["cls_token"] = torch.zeros((cfg.hidden,), dtype=dt,
                                          device=dev)
    if cfg.num_classes:
        params["head"] = _init(gen, (cfg.hidden, cfg.num_classes), dt)
    return params


def patchify(images: torch.Tensor, patch: int) -> torch.Tensor:
    """[B, H, W, C] → [B, N, P²·C] without a conv (one reshape/permute)."""
    b, h, w, c = images.shape
    gh, gw = h // patch, w // patch
    x = images.reshape(b, gh, patch, gw, patch, c)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, gh * gw, patch * patch * c)


def _vit_tokens(params: Params, images: torch.Tensor, cfg: ViTConfig,
                ax: Optional[VisionAxes]) -> torch.Tensor:
    """The encoder's input at this rank's positions: patches through
    ``patch_embed``, the class token first, plus their ``pos_embed``
    rows."""
    dt = cfg.activation_dtype
    x = patchify(images.to(dt), cfg.patch_size)
    x = x @ params["patch_embed"].to(dt)
    if cfg.pool == "cls":
        cls = params["cls_token"].to(dt).expand(x.shape[0], 1, cfg.hidden)
        x = torch.cat([cls, x], dim=1)
    x = x + params["pos_embed"].to(dt)
    if ax is not None and ax.seq_size > 1:
        a, b = ax.span(cfg.seq_len)
        x = x[:, a:b]
    return x


def _pool(x: torch.Tensor, cfg: ViTConfig,
          ax: Optional[VisionAxes]) -> torch.Tensor:
    """``cls`` (position 0) or ``gap`` (the mean over every position)
    features [B, D] of the encoder's output at this rank's positions,
    summed over ``seq`` (``seq_sum``): position 0 counts on the rank that
    holds it, each rank adds its positions to the mean."""
    if ax is None or ax.seq_size == 1:
        return x[:, 0] if cfg.pool == "cls" else x.mean(dim=1)
    a, b = ax.span(cfg.seq_len)
    if cfg.pool != "cls":
        return seq_sum(x.sum(dim=1) / cfg.seq_len, ax)
    # A rank without position 0 adds zeros that stay in the graph: every
    # rank runs the sum's backward.
    return seq_sum(x[:, 0] if a == 0 and b > 0 else x.sum(dim=1) * 0, ax)


def _vit_features(params: Params, images: torch.Tensor, cfg: ViTConfig,
                  ax: Optional[VisionAxes]) -> torch.Tensor:
    x = _encode(params, _vit_tokens(params, images, cfg, ax), cfg, ax=ax,
                seq_len=cfg.seq_len)
    return _pool(x, cfg, ax)


def _vit_logits(params: Params, feats: torch.Tensor, cfg: ViTConfig,
                ax: Optional[VisionAxes]) -> tuple[torch.Tensor, int]:
    """fp32 logits of this rank's classes (the head's columns over the
    model axis, its input through ``copy_to_model``; products of
    activation-dtype operands, accumulated and returned in fp32) and the
    first class's index."""
    dt = cfg.activation_dtype
    head = rank_part_of(params["head"], 1, cfg.num_classes, _tp(ax),
                        "classes")
    return (C.copy_to_model(feats, _tp(ax)).float()
            @ head.to(dt).float()), C.axis_part(cfg.num_classes, _tp(ax))[0]


def vit_forward(params: Params, images: torch.Tensor,
                cfg: ViTConfig) -> torch.Tensor:
    """[B, H, W, C] images → [B, num_classes] fp32 logits (or [B, D]
    features in the activation dtype)."""
    feats = _vit_features(params, images, cfg, None)
    if not cfg.num_classes:
        return feats
    return _vit_logits(params, feats, cfg, None)[0]


def vit_loss(params: Params, batch: dict, cfg: ViTConfig, *, mesh=None):
    """Cross-entropy classification. batch: {"images", "labels"}. Under
    ``mesh`` the batch is this rank's rows (its batch shard's, the same on
    the ``seq``, ``model``, ``expert`` and ``pipeline`` ranks of it): the
    CE is vocab-parallel over the model axis's class shards (the argmax
    across them); ``loss`` is this rank's part of the global mean (the
    parts over the batch and ``copies`` ranks sum to it), the metrics the
    global values."""
    ax = vision_axes(mesh)
    feats = _vit_features(params, batch["images"], cfg, ax)
    logits, lo = _vit_logits(params, feats, cfg, ax)
    labels = batch["labels"].long()
    if _tp(ax) is not None:
        nll, hits = VP.vocab_parallel_ce(logits, labels, ax.tp, lo)
    else:
        logp = torch.log_softmax(logits, dim=-1)
        nll = -torch.gather(logp, -1, labels[:, None])[:, 0]
        hits = (logits.argmax(-1) == labels).float()
    if ax is None:
        loss = nll.mean()
        return loss, {"loss": loss.detach(), "accuracy": hits.mean()}
    sums = torch.stack([nll.sum().detach(), hits.sum(),
                        torch.tensor(float(nll.numel()), device=nll.device)])
    C.all_reduce_(sums, ax.batch)
    loss = nll.sum() / sums[2] / ax.copies
    return loss, {"loss": sums[0] / sums[2], "accuracy": sums[1] / sums[2]}


# -- CLIP ------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    """Dual encoder: ViT image tower + causal text tower + shared proj dim."""

    image: ViTConfig = dataclasses.field(
        default_factory=lambda: dataclasses.replace(
            VIT_PRESETS["vit-l16"], num_classes=0))
    text_vocab: int = 49408
    text_len: int = 77
    text_hidden: int = 768
    text_layers: int = 12
    text_heads: int = 12
    text_mlp: int = 3072
    proj_dim: int = 768
    dtype: str = "bfloat16"
    param_dtype: str = "float32"

    @property
    def text_cfg(self) -> ViTConfig:
        """The text tower reuses the encoder trunk config-shape."""
        return ViTConfig(
            hidden=self.text_hidden, n_layers=self.text_layers,
            n_heads=self.text_heads, mlp_dim=self.text_mlp,
            num_classes=0, scan_layers=True, dtype=self.dtype,
            param_dtype=self.param_dtype)


CLIP_PRESETS: dict[str, CLIPConfig] = {
    "clip-l14": CLIPConfig(),
    "tiny-clip": CLIPConfig(
        image=ViTConfig(image_size=32, patch_size=8, hidden=64, n_layers=2,
                        n_heads=4, mlp_dim=128, num_classes=0),
        text_vocab=256, text_len=16, text_hidden=64, text_layers=2,
        text_heads=4, text_mlp=128, proj_dim=32),
}


def clip_preset(name: str, **overrides) -> CLIPConfig:
    return dataclasses.replace(CLIP_PRESETS[name], **overrides)


def init_clip_params(gen: torch.Generator, cfg: CLIPConfig) -> Params:
    """Random CLIP weights from ``gen`` on ``gen``'s device; the learned
    temperature starts at log(1/0.07), as in the paper."""
    tcfg = cfg.text_cfg
    image = init_vit_params(gen, cfg.image)
    tdt = tcfg.weight_dtype
    text = {
        "embed": _init(gen, (cfg.text_vocab, tcfg.hidden), tdt, scale=0.02),
        "pos_embed": _init(gen, (cfg.text_len, tcfg.hidden), tdt,
                           scale=0.01),
        "layers": _init_layers(gen, tcfg),
        "final_ln": _init_layernorm(tcfg, tcfg.hidden, gen.device),
    }
    return {
        "image": image,
        "text": text,
        "img_proj": _init(gen, (cfg.image.hidden, cfg.proj_dim),
                          cfg.image.weight_dtype),
        "txt_proj": _init(gen, (tcfg.hidden, cfg.proj_dim), tdt),
        "logit_scale": torch.tensor(math.log(1.0 / 0.07),
                                    dtype=torch.float32, device=gen.device),
    }


def clip_param_specs(cfg: CLIPConfig) -> Params:
    """Logical-axis spec tree mirroring ``init_clip_params``."""
    return {
        "image": vit_param_specs(cfg.image),
        "text": {
            "embed": ("vocab", "embed_table"),
            "pos_embed": (None, None),
            "layers": _stacked_specs(),
            "final_ln": {"scale": ("norm",), "bias": ("norm",)},
        },
        "img_proj": ("embed", None),
        "txt_proj": ("embed", None),
        "logit_scale": (),
    }


def clip_encode_image(params: Params, images: torch.Tensor,
                      cfg: CLIPConfig,
                      ax: Optional[VisionAxes] = None) -> torch.Tensor:
    feats = _vit_features(params["image"], images, cfg.image, ax)
    return feats @ params["img_proj"].to(feats.dtype)


def clip_encode_text(params: Params, tokens: torch.Tensor, cfg: CLIPConfig,
                     ax: Optional[VisionAxes] = None) -> torch.Tensor:
    """The text tower (at this rank's positions under ``ax``): the
    embedding vocab-parallel over the model axis (``layers.vocab_rows``),
    causal attention from the rank's global offset, and EOT pooling at
    the global position of the highest token id (CLIP convention; argmax
    takes the first of equal ids, as jnp.argmax does), which one ``seq``
    rank holds."""
    tcfg = cfg.text_cfg
    dt = tcfg.activation_dtype
    p = params["text"]
    tokens = tokens.long()
    s = tokens.shape[1]
    a, b = (0, s) if ax is None else ax.span(s)
    x = vocab_rows(p["embed"], tokens[:, a:b], cfg.text_vocab, _tp(ax), dt)
    x = x + p["pos_embed"].to(dt)[a:b]
    x = _encode(p, x, tcfg, causal=True, ax=ax, seq_len=s)
    eot = tokens.argmax(dim=-1)
    rows = torch.arange(x.shape[0], device=x.device)
    if ax is None or ax.seq_size == 1:
        feats = x[rows, eot]
    elif b > a:
        held = ((eot >= a) & (eot < b))[:, None].to(x.dtype)
        feats = seq_sum(x[rows, (eot - a).clamp(0, b - a - 1)] * held, ax)
    else:
        feats = seq_sum(x.sum(dim=1) * 0, ax)
    return feats @ params["txt_proj"].to(feats.dtype)


def clip_loss(params: Params, batch: dict, cfg: CLIPConfig, *, mesh=None):
    """Symmetric InfoNCE over the global batch. batch: {"images",
    "tokens"}. Under ``mesh`` the batch is this rank's rows: the features
    are all-gathered over the batch ranks (the negatives of every rank),
    every rank computes the same global loss, and ``loss`` is its part,
    1 / (batch ranks · copies) of it (the gather's backward sums the batch
    ranks' gradients, ``seq_sum``'s the ``seq`` ranks')."""
    ax = vision_axes(mesh)
    img = clip_encode_image(params, batch["images"], cfg, ax).float()
    txt = clip_encode_text(params, batch["tokens"], cfg, ax).float()
    group = None if ax is None else ax.batch
    img = C.gather_dim(img, 0, group)
    txt = C.gather_dim(txt, 0, group)
    img = img / (torch.linalg.norm(img, dim=-1, keepdim=True) + 1e-8)
    txt = txt / (torch.linalg.norm(txt, dim=-1, keepdim=True) + 1e-8)
    scale = torch.exp(torch.clamp(params["logit_scale"], -5.0,
                                  math.log(100.0)))
    logits = scale * img @ txt.T                      # [B, B]
    labels = torch.arange(logits.shape[0], device=logits.device)
    li = -torch.log_softmax(logits, dim=1)[labels, labels].mean()
    lt = -torch.log_softmax(logits, dim=0)[labels, labels].mean()
    loss = (li + lt) / 2
    metrics = {
        "loss": loss.detach(),
        "img_to_txt_acc": (logits.argmax(1) == labels).float().mean(),
        "temperature": (1.0 / scale).detach(),
    }
    copies = 1 if ax is None else ax.copies
    return loss / (C.group_size(group) * copies), metrics
