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
trees). Under a mesh the losses take this rank's batch rows and
``batch_group`` (the ranks over the batch axes): ViT's mean is the global
one, and CLIP's contrastive logits span the global batch (the features
all-gathered over the group).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from kubeflow_tpu_torch.models.config import torch_dtype
from kubeflow_tpu_torch.models.decoder import layer_view
from kubeflow_tpu_torch.models.layers import _init
from kubeflow_tpu_torch.ops.attention import multi_head_attention
from kubeflow_tpu_torch.parallel.collectives import gather_dim, group_size

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


def _encoder_block(p: dict, x: torch.Tensor, cfg: ViTConfig, *,
                   causal: bool = False) -> torch.Tensor:
    dt = cfg.activation_dtype
    b, s, d = x.shape
    h = _layernorm(p["ln1"], x, cfg.norm_eps)
    # "bsd,dthk->tbshk" as one matmul over wqkv's [D, 3·H·Dh] view.
    qkv = (h @ p["wqkv"].to(dt).reshape(d, -1)).reshape(
        b, s, 3, cfg.n_heads, cfg.head_dim)
    out = multi_head_attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2],
                               causal=causal)
    x = x + out.reshape(b, s, -1) @ p["wo"].to(dt).reshape(-1, d)
    h = _layernorm(p["ln2"], x, cfg.norm_eps)
    h = torch.nn.functional.gelu(h @ p["w1"].to(dt) + p["b1"].to(dt),
                                 approximate="tanh")
    return x + (h @ p["w2"].to(dt) + p["b2"].to(dt))


def _encode(params: Params, x: torch.Tensor, cfg: ViTConfig, *,
            causal: bool = False) -> torch.Tensor:
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
                bp, x, cfg, causal=causal), x, use_reentrant=False)
        else:
            x = _encoder_block(bp, x, cfg, causal=causal)
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


def vit_forward(params: Params, images: torch.Tensor,
                cfg: ViTConfig) -> torch.Tensor:
    """[B, H, W, C] images → [B, num_classes] fp32 logits (or [B, D]
    features in the activation dtype)."""
    dt = cfg.activation_dtype
    x = patchify(images.to(dt), cfg.patch_size)
    x = x @ params["patch_embed"].to(dt)
    if cfg.pool == "cls":
        cls = params["cls_token"].to(dt).expand(x.shape[0], 1, cfg.hidden)
        x = torch.cat([cls, x], dim=1)
    x = x + params["pos_embed"].to(dt)
    x = _encode(params, x, cfg)
    feats = x[:, 0] if cfg.pool == "cls" else x.mean(dim=1)
    if cfg.num_classes:
        # Products of activation-dtype operands, accumulated and returned
        # in fp32.
        return feats.float() @ params["head"].to(dt).float()
    return feats


def vit_loss(params: Params, batch: dict, cfg: ViTConfig,
             batch_group=None):
    """Cross-entropy classification. batch: {"images", "labels"}. With
    ``batch_group`` the batch is this rank's rows: ``loss`` is its part of
    the global mean (the parts sum to it), the metrics the global
    values."""
    logits = vit_forward(params, batch["images"], cfg).float()
    logp = torch.log_softmax(logits, dim=-1)
    labels = batch["labels"].long()
    nll = -torch.gather(logp, -1, labels[:, None])[:, 0]
    hits = (logits.argmax(-1) == labels).float()
    if batch_group is None:
        loss = nll.mean()
        return loss, {"loss": loss.detach(), "accuracy": hits.mean()}
    sums = torch.stack([nll.sum().detach(), hits.sum(),
                        torch.tensor(float(nll.numel()), device=nll.device)])
    torch.distributed.all_reduce(sums, group=batch_group)
    loss = nll.sum() / sums[2]
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
                      cfg: CLIPConfig) -> torch.Tensor:
    feats = vit_forward(params["image"], images, cfg.image)
    return feats @ params["img_proj"].to(feats.dtype)


def clip_encode_text(params: Params, tokens: torch.Tensor,
                     cfg: CLIPConfig) -> torch.Tensor:
    tcfg = cfg.text_cfg
    dt = tcfg.activation_dtype
    p = params["text"]
    tokens = tokens.long()
    x = p["embed"].to(dt)[tokens] + p["pos_embed"].to(dt)
    x = _encode(p, x, tcfg, causal=True)
    # EOT pooling: the highest token id marks end-of-text (CLIP convention;
    # argmax takes the first of equal ids, as jnp.argmax does).
    eot = tokens.argmax(dim=-1)
    feats = x[torch.arange(x.shape[0], device=x.device), eot]
    return feats @ params["txt_proj"].to(feats.dtype)


def clip_loss(params: Params, batch: dict, cfg: CLIPConfig,
              batch_group=None):
    """Symmetric InfoNCE over the global batch. batch: {"images",
    "tokens"}. With ``batch_group`` the batch is this rank's rows: the
    features are all-gathered over the group (the negatives of every
    rank), every rank computes the same global loss, and ``loss`` is its
    1/n part (the gather's backward sums the n ranks' gradients)."""
    img = clip_encode_image(params, batch["images"], cfg).float()
    txt = clip_encode_text(params, batch["tokens"], cfg).float()
    img = gather_dim(img, 0, batch_group)
    txt = gather_dim(txt, 0, batch_group)
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
    return loss / group_size(batch_group), metrics
