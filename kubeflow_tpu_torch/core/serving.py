"""Engine knobs for the port's serving path — a dataclass copy of the
``kubeflow_tpu/core/serving.py`` ``BatchingSpec`` fields this slice reads,
plus the QoS class table. (The JAX package's spec is a pydantic model; the
port keeps to the standard library.)

Fields for features a later slice brings (the host and remote KV tiers,
weight quantization, disaggregated roles, LoRA, speculative decoding) are
kept so a config that sets them fails loudly at engine construction
instead of being ignored.
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

#: Engine roles (``unified`` is the only one this slice serves).
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
class BatchingSpec:
    """Continuous-batching engine knobs (≈ vLLM engine args)."""

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
    # Host-RAM and remote-store KV tiers (a later slice: the engine refuses
    # host_kv_pages > 0 and remote_kv_root).
    host_kv_pages: int = 0
    kv_demote_after_s: float = 2.0
    kv_migrate_batch_pages: int = 32
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
    quantize: Optional[str] = None
    # KV storage dtype of the PAGED pool: "int8" stores K/V as int8 with
    # per-token-per-head scales (ops/quantization.py). None = the model's
    # activation dtype.
    kv_cache_dtype: Optional[str] = None
    # "auto": the flash kernel on CUDA for buckets >= 2048 that are a
    # multiple of 128, plain attention elsewhere; or force "pallas"/"xla".
    prefill_attn_impl: str = "auto"
    # Bounded admission: submit() rejects once this many requests wait
    # (0 = unbounded); requests waiting longer than the budget are shed.
    max_queue: int = 0
    queue_delay_budget: Optional[float] = None
    qos: QoSSpec = dataclasses.field(default_factory=QoSSpec)
    # Later slices: set to anything but None and the engine refuses.
    lora: Optional[dict] = None
    speculative: Optional[dict] = None

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
