"""Engine knobs for the port's serving path — a dataclass copy of the
``kubeflow_tpu/core/serving.py`` ``BatchingSpec`` fields this slice reads,
plus the QoS class table, the multi-tenant ``LoRASpec`` and the
``SpeculativeSpec``. (The JAX package's specs are pydantic models; the port
keeps to the standard library, with the same checks and messages.) Every
field of the JAX ``BatchingSpec`` is here, so a dump of the JAX spec
configures the port's engine; the engine validates ``quantize`` and the
``moe_*_impl`` fields where the JAX engine does.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

#: Multi-tenant QoS classes, highest priority first. The order IS the
#: policy: admission dequeues strictly by it, overload sheds from the
#: BACK of it, and cross-class preemption only ever evicts a strictly
#: lower class.
QOS_CLASSES = ("interactive", "standard", "batch")

#: class name -> priority rank (lower = more urgent).
QOS_PRIORITY = {c: i for i, c in enumerate(QOS_CLASSES)}

#: Default class for requests that declare none.
QOS_DEFAULT = "standard"

#: Engine roles for disaggregated prefill/decode serving. ``unified`` is
#: the classic engine; ``prefill`` runs the prompt, samples the FIRST token
#: and exports the slot's KV as a handoff instead of decoding; ``decode``
#: adopts handed-off KV into its own page pool and runs the decode loop.
#: Every role keeps the whole engine, so any replica can serve a request
#: alone (the unified fallback).
ENGINE_ROLES = ("unified", "prefill", "decode")


@dataclasses.dataclass
class QoSClassPolicy:
    """Per-class admission knobs; unset fields inherit the engine-wide
    ``BatchingSpec.max_queue`` / ``queue_delay_budget`` behavior."""

    max_queue: int = 0
    queue_delay_budget: Optional[float] = None

    def __post_init__(self) -> None:
        if self.max_queue < 0:
            raise ValueError("max_queue must be >= 0")
        if self.queue_delay_budget is not None and self.queue_delay_budget <= 0:
            raise ValueError("queue_delay_budget must be positive")


@dataclasses.dataclass
class QoSSpec:
    """Per-class admission quotas/budgets plus cross-class recompute
    preemption (class priority itself is fixed by ``QOS_CLASSES``)."""

    classes: dict = dataclasses.field(default_factory=dict)
    preemption: bool = True

    def __post_init__(self) -> None:
        unknown = set(self.classes) - set(QOS_CLASSES)
        if unknown:
            raise ValueError(f"unknown QoS classes {sorted(unknown)}; "
                             f"known: {list(QOS_CLASSES)}")
        self.classes = {k: (v if isinstance(v, QoSClassPolicy)
                            else QoSClassPolicy(**v))
                        for k, v in self.classes.items()}


@dataclasses.dataclass
class SpeculativeSpec:
    """Speculative decoding knobs (serve/spec_decode.py). Greedy requests
    draft up to ``k`` tokens per round and verify them all in one batched
    dispatch, at output identical to plain greedy decode. ``mode``:
    ``ngram`` looks the context's last n-gram (``ngram_max`` down to
    ``ngram_min`` tokens) up in the request's own earlier tokens;
    ``draft_model`` runs a small decoder (``draft`` = {"preset",
    "overrides"}, the target's vocabulary) ahead autoregressively; ``off``
    turns the path off. Sampled requests take the plain decode path."""

    mode: str = "off"
    k: int = 4
    ngram_max: int = 3
    ngram_min: int = 1
    draft: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self) -> None:
        if self.mode not in ("off", "ngram", "draft_model"):
            raise ValueError(
                f"unknown speculative mode {self.mode!r}; "
                "one of off|ngram|draft_model")
        if self.mode != "off" and not (1 <= self.k <= 64):
            raise ValueError("speculative.k must be in [1, 64]")
        if self.mode == "ngram" and not (
                1 <= self.ngram_min <= self.ngram_max):
            raise ValueError("need 1 <= ngram_min <= ngram_max")


@dataclasses.dataclass
class LoRASpec:
    """Multi-tenant LoRA serving knobs (serve/lora.py): one engine serves up
    to ``max_adapters`` rank-``rank`` adapters over shared base weights,
    hot-loading and evicting through the adapter registry.

    ``max_adapters`` sizes the packed device buffers (the slot count);
    ``rank`` is the per-slot rank cap lower-rank adapters zero-pad to;
    ``targets`` names the attention projections the low-rank update applies
    to (wq/wk/wv/wo). ``max_adapters=0`` turns the subsystem off."""

    max_adapters: int = 0
    rank: int = 8
    alpha: float = 16.0
    targets: tuple = ("wq", "wv")

    def __post_init__(self) -> None:
        self.targets = tuple(self.targets)
        if self.max_adapters < 0:
            raise ValueError("max_adapters must be >= 0")
        if self.max_adapters and not (1 <= self.rank <= 64):
            raise ValueError("lora.rank must be in [1, 64]")
        bad = set(self.targets) - {"wq", "wk", "wv", "wo"}
        if self.max_adapters and (bad or not self.targets):
            raise ValueError(
                f"lora.targets must be a non-empty subset of "
                f"wq/wk/wv/wo; got {self.targets}")


@dataclasses.dataclass
class BatchingSpec:
    """Continuous-batching engine knobs (≈ vLLM engine args)."""

    # Disaggregated serving role (ENGINE_ROLES).
    role: str = "unified"
    max_batch_size: int = 8          # decode batch slots
    max_seq_len: int = 2048
    # Paged KV cache: a pool of pages decoupled from slots x max_seq_len;
    # shared-prefix requests reuse pages.
    paged: bool = False
    page_size: int = 128             # KV cache page (tokens)
    max_pages: Optional[int] = None  # default: slots x max_seq_len / page
    enable_prefix_caching: bool = True
    # Prefix-cache index: "radix" (token-block radix tree with live
    # copy-on-write sharing, serve/kvtier.py) or "flat" (full-page chained
    # hash in PageAllocator).
    prefix_index: str = "radix"
    # Host-RAM overflow tier (radix index only): cold sharer-free prefix
    # pages migrate device→host on a background thread and promote back on
    # a radix hit before prefill admits. Page budget of the host tier;
    # 0 = off.
    host_kv_pages: int = 0
    # A cached (sharer-free) device page idle this long may demote; one
    # migration batch moves at most kv_migrate_batch_pages pages.
    kv_demote_after_s: float = 2.0
    kv_migrate_batch_pages: int = 32
    # Remote-store third tier (radix index with a host tier): host blobs
    # idle past kv_remote_after_s (default 2 x kv_demote_after_s) spill into
    # the artifact store at remote_kv_root (or $KFTPU_KV_REMOTE_ROOT), and
    # a radix miss on any replica probes it, every match's store work
    # bounded by kv_remote_deadline_s (default $KFTPU_KV_REMOTE_DEADLINE_S,
    # else 0.5 s).
    remote_kv_root: Optional[str] = None
    kv_remote_after_s: Optional[float] = None
    kv_remote_deadline_s: Optional[float] = None
    # Paged decode attention: "gather" (materialise pages, plain attention),
    # "pallas" (the hand-written paged-decode kernel), or "auto" (the
    # kernel on CUDA, gather on the CPU).
    paged_attn_impl: str = "auto"
    # Long prompts split into chunks with decode interleaving; this many may
    # chunk concurrently.
    max_concurrent_prefills: int = 2
    # Up to this many same-bucket waiting prompts share one prefill dispatch
    # (power-of-two group sizes); 1 = off.
    prefill_batch_max: int = 4
    # group_size × bucket never exceeds this many tokens (the group
    # multiplies scratch KV and the [N, bucket, V] logits).
    prefill_batch_token_budget: int = 4096
    chunked_prefill_tokens: int = 512
    prefill_buckets: list = dataclasses.field(
        default_factory=lambda: [128, 512, 2048])
    # Decode steps per device dispatch (sampling runs on the device).
    decode_steps: int = 32
    # Decode steps per dispatch while a chunked prefill is in flight.
    prefill_interleave_steps: int = 8
    # Dispatch round N+1 before consuming round N's tokens (one round stale,
    # bounded; greedy outputs are token-identical on and off).
    pipelined_decode: bool = True
    # Cast model weights once at engine load (e.g. "bfloat16").
    weights_dtype: Optional[str] = None
    # Weight-only quantization at engine load: "int8" packs the big matmuls
    # per output channel (ops/quantization.py) and dequantizes them in the
    # product's operand. None = off.
    quantize: Optional[str] = None
    # KV storage dtype of the PAGED pool: "int8" stores K/V as int8 with
    # per-token-per-head scales (ops/quantization.py). None = the model's
    # activation dtype.
    kv_cache_dtype: Optional[str] = None
    # "auto": the flash kernel on CUDA for buckets >= 2048 that are a
    # multiple of 128, plain attention elsewhere; or force "pallas"/"xla".
    prefill_attn_impl: str = "auto"
    # MoE expert path per phase. Prefill runs one request per dispatch, so
    # capacity drops never depend on co-batched neighbours: "auto" takes
    # the model's moe_impl (dispatch), "dense" forces the every-expert
    # oracle. Decode co-batches slots, so its only batch-independent
    # dispatch is "zero_drop" (capacity k x batch: nothing can drop);
    # "auto" is dense.
    moe_prefill_impl: str = "auto"   # auto|dispatch|dense
    moe_decode_impl: str = "auto"    # auto|zero_drop|dense
    # Bounded admission: submit() rejects once this many requests wait
    # (0 = unbounded); requests waiting longer than the budget are shed.
    max_queue: int = 0
    queue_delay_budget: Optional[float] = None
    qos: QoSSpec = dataclasses.field(default_factory=QoSSpec)
    # Multi-tenant LoRA adapters over shared base weights (serve/lora.py):
    # requests carrying a registered model id decode through their
    # adapter's packed low-rank slices in the same batched dispatch as base
    # traffic. max_adapters=0 (the default) = off.
    lora: LoRASpec = dataclasses.field(default_factory=LoRASpec)
    # Speculative decoding (draft + batched verify, serve/spec_decode.py):
    # greedy requests emit several verified tokens per dispatch.
    speculative: SpeculativeSpec = dataclasses.field(
        default_factory=SpeculativeSpec)

    def __post_init__(self) -> None:
        if self.role not in ENGINE_ROLES:
            raise ValueError(
                f"unknown engine role {self.role!r}; one of {ENGINE_ROLES}")
        if self.prefix_index not in ("radix", "flat"):
            raise ValueError(
                f"unknown prefix_index {self.prefix_index!r}; "
                "one of radix|flat")
        if self.host_kv_pages and self.prefix_index != "radix":
            raise ValueError(
                "host_kv_pages requires prefix_index='radix' (the "
                "flat hash has no tier lifecycle)")
        if self.remote_kv_root and not self.host_kv_pages:
            raise ValueError(
                "remote_kv_root requires host_kv_pages > 0 (the third "
                "tier spills from the host tier, not the device)")
        if self.prefill_attn_impl not in ("auto", "pallas", "xla"):
            raise ValueError(
                f"unknown prefill_attn_impl {self.prefill_attn_impl!r}; "
                "one of auto|pallas|xla")
        if isinstance(self.qos, dict):
            self.qos = QoSSpec(**self.qos)
        if self.speculative is None:
            self.speculative = SpeculativeSpec()
        elif isinstance(self.speculative, dict):
            self.speculative = SpeculativeSpec(**self.speculative)
        if self.lora is None:
            self.lora = LoRASpec()
        elif isinstance(self.lora, dict):
            self.lora = LoRASpec(**self.lora)
        if self.lora.max_adapters:
            if self.role != "unified":
                # Handoff payloads carry KV only: the adopting engine would
                # need the same adapter hot to continue decoding.
                raise ValueError(
                    "lora.max_adapters requires role='unified' "
                    "(adapter KV cannot ride a handoff)")
            if self.speculative.mode != "off":
                raise ValueError(
                    "lora.max_adapters requires speculative.mode='off' "
                    "(the verify dispatch has no adapter lane yet)")
