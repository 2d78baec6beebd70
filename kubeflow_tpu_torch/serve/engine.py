"""Continuous-batching LLM decode engine — the port of
``kubeflow_tpu/serve/engine.py``'s unified-role path, on the contiguous
slot cache or the paged pool.

Design (what carries over, and what eager PyTorch changes):

- **Slot KV cache.** ``[L, B, Smax, KV, Dh]`` with per-slot lengths; a slot
  is the unit of admission. Cache writes are in place. Dead rows (free
  slots, finished slots, a slot mid chunked prefill) never change the
  cache: their decode write is a masked rewrite of the value already at
  the row's position 0 — torch has no "drop" scatter mode, and a slot
  mid chunked prefill has real KV at position 0.
- **Prefill reuses the model forward** (``models/decoder.decoder_forward``)
  on an ``[N, bucket]`` block with a scratch cache, then copies the K/V
  into the slot rows; with ``prefill_attn_impl="pallas"`` (or "auto" on
  CUDA for buckets >= 2048) the block's attention runs the hand-written
  flash kernel. Prompts longer than ``chunked_prefill_tokens`` prefill one
  chunk per scheduler step with decode interleaving between chunks.
- **Multi-step decode with on-device sampling.** One dispatch runs up to
  ``decode_steps`` decode+sample steps. The JAX engine's ``while_loop``
  exits early once every slot finishes; in eager torch that test is a host
  synchronisation per step, so ``_decode_multi`` runs all its steps
  (finished rows are masked: the same output) and the scheduler instead
  sizes each dispatch to the most steps any slot can still take — its
  remaining token budget and cache room, less the steps already in flight
  — and skips the dispatch when that is zero. Only an early stop token
  costs idle steps.
- **Device-resident decode state + pipelined dispatch** (serve/
  device_state.py): the scheduler dispatches round N+1 before consuming
  round N's tokens; each round's token block is copied to pinned host
  memory behind an event recorded right after its kernels, so consuming
  round N never waits for round N+1. Staleness is one round deep; a
  cancelled slot's in-flight results are masked before emission.
- **Request lifecycle**: deadlines, cancellation, bounded admission
  (``EngineOverloaded`` → HTTP 429), queue-delay shedding, strict QoS
  priority and cross-class recompute preemption, exactly as the JAX
  engine.
- **Paged KV** (``paged=True``, serve/paged.py): a pool of pages
  ``[L, P + 1, page, KV, Dh]`` (bf16, or int8 with per-token scale planes),
  a host page-table mirror whose dirty rows sync to the device table, and
  chunked admission into pages (every paged admission chunks). The radix
  prefix index (serve/kvtier.py) shares prompt and conversation pages
  live, with copy-on-write of a diverging partial tail; the flat index
  keeps the full-page chained hash. Pool pressure preempts the youngest
  slot (recompute), and a chunked prefill starved of pages aborts and
  requeues. Decode attention reads pages through the hand-written
  paged-decode kernel (``paged_attn_impl="pallas"``, the "auto" choice on
  CUDA) or gathers them ("gather", the CPU's "auto"). The pool's last page
  is a sink that takes every write the JAX engine would drop.

- **Disaggregated roles** (``BatchingSpec.role``, serve/handoff.py): a
  ``prefill`` engine stops a request at its first token and exports the
  prompt's KV (its pages move to a hold released by the decode side's ack);
  a ``decode`` engine adopts a payload into fresh pages with one scatter
  and decodes from the second token. Every role keeps the whole engine, so
  any replica can still serve a request alone (``handoff=False``).
- **Host-RAM KV tier** (``host_kv_pages``, serve/kvtier.py): cold cached
  prefix pages demote to host memory on a background thread and promote
  back on a radix hit before the admission's prefill.
- **Remote KV tier** (``remote_kv_root`` or ``$KFTPU_KV_REMOTE_ROOT``,
  serve/storage.kv_fabric_store): host blobs idle past
  ``kv_remote_after_s`` spill into the artifact store under keys any
  replica of the same cache geometry derives from the tokens, so a
  conversation's next turn on another replica adopts its prefix;
  ``drain_kv_to_remote`` pushes every cached prefix out before a scale
  down.
- **Multi-tenant LoRA** (``BatchingSpec.lora``, serve/lora.py): a request's
  ``adapter`` (its model id) acquires a slot of the registry's packed
  buffers at admission, hot-loading on a miss (the ``engine.adapter_load``
  span) and requeueing when every slot is referenced; every dispatch passes
  the packed buffers and a per-row adapter index (-1 = base weights, an
  exact zero delta), and the prefix index keys each adapter's KV in its own
  namespace.
- **Speculative decoding** (``BatchingSpec.speculative``,
  serve/spec_decode.py): when every running request is greedy, the
  scheduler drains the pipeline, drafts up to k tokens per slot (n-gram
  lookup, or a small draft model over its own dense slot cache), verifies
  all k + 1 positions of every slot in one dispatch (on the page pool
  through the paged-decode kernel over B·T rows), emits the accepted run
  plus the correction token, and rolls the rejected tail's pages back. A
  round with no draft, and any batch with a sampled request, takes the
  plain path.

- **MoE and int8 weights**: an MoE model's prefill and decode each take
  their own expert path (``_cfg_prefill`` / ``_cfg_decode``, from
  ``moe_prefill_impl`` / ``moe_decode_impl``): prefill dispatches one
  request at a time with its bucket's pads masked out of the expert
  capacity, decode runs the drop-free dense path (or the zero-drop
  dispatch), so a request's tokens never depend on its neighbours.
  ``quantize="int8"`` packs the matmul weights (after the
  ``weights_dtype`` cast; a fresh engine packs each layer as it draws it).

- **Tensor parallelism** (``mesh`` with a ``model`` axis, one process
  per card): every rank builds the engine on its shards — weights cut by
  the training rules (``decoder_param_specs``; heads, mlp columns and
  vocab over ``model``, a dim that does not divide whole on every rank,
  each rank computing its part: ``layers.head_owners``),
  KV caches and page pools (bf16 or int8 with their scales) on the kv
  heads its q heads read — and the layers run Megatron's split
  (``models/layers.py``): the flash prefill and the paged-decode kernel
  on the local heads, one all-reduce after ``wo`` and one after ``down``,
  the logits all-gathered before sampling. Rank 0 runs the scheduler;
  every device call that reads weights or writes KV goes through one
  dispatcher (``serve/tp_dispatch.py``), which sends it to the other
  ranks, idle in ``follow``. Sampling runs on every rank from the same
  seeded generator. An MoE model runs its phases' expert paths on each
  rank's columns of every expert (``expert_mlp`` over ``model``: the
  prefill dispatch one request at a time with its bucket's pads masked,
  decode dense or zero-drop), the partial outputs summed with the
  attention's in the same way. Engine roles, the handoff and the host
  and remote KV tiers run as on one card, their payloads and blobs
  whole-model (every kv head, the JAX wire format): a read of KV (an
  export, a demotion) gathers the ranks' heads on the leader, a write (an
  adoption, a promotion) sends whole-model blocks and each rank keeps its
  heads. The explainers run as a dispatched op on every rank
  (``explain``). Speculative decoding and LoRA (ROADMAP.md Queue 1 item
  9e3) and any serving axis but ``model`` (``expert`` among them; item
  9e2) raise under a mesh.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import itertools
import logging
import queue
import threading
import time
from typing import Any, Optional

import numpy as np
import torch

from kubeflow_tpu_torch.core.serving import (
    BatchingSpec, QOS_DEFAULT, QOS_PRIORITY,
)
from kubeflow_tpu_torch.device import resolve_device
from kubeflow_tpu_torch.models import layers as L
from kubeflow_tpu_torch.models.config import (
    DecoderConfig, model_axis_of, preset, torch_dtype, with_model_axis,
)
from kubeflow_tpu_torch.models.decoder import (
    Params, decoder_forward, decoder_layout, ffn, init_decoder_params,
    layer_view, lm_head,
)
from kubeflow_tpu_torch.obs.stats import quantile as _quantile
from kubeflow_tpu_torch.ops.quantization import (
    QuantizedTensor, check_quantize, contraction_dims, quantize_params_int8,
)
from kubeflow_tpu_torch.obs.trace import get_tracer
from kubeflow_tpu_torch.parallel import collectives as C
from kubeflow_tpu_torch.serve.device_state import DEAD_SLOT, DecodeState
from kubeflow_tpu_torch.serve.explain import (
    attribution_cfg, handler_of, run_handler,
)
from kubeflow_tpu_torch.serve.handoff import (
    host_array, payload_from_export, to_torch, torch_dtype_of,
)
from kubeflow_tpu_torch.serve.kvtier import RadixPrefixIndex
from kubeflow_tpu_torch.serve.lora import (
    AdapterRegistry, AdapterSlotsExhausted,
)
from kubeflow_tpu_torch.serve.paged import (
    PageAllocator, PagePoolExhausted, context_bucket, copy_pages,
    gather_pages, paged_chunk_prefill, paged_decode_multi, upload_pages,
)
from kubeflow_tpu_torch.serve.spec_decode import (
    draft_propose, ngram_propose, paged_verify_step, verify_step,
)
from kubeflow_tpu_torch.serve.storage import kv_fabric_store
from kubeflow_tpu_torch.serve.tp_dispatch import Dispatcher, gather_kv_heads

logger = logging.getLogger("kubeflow_tpu_torch.serve.engine")


class EngineOverloaded(Exception):
    """The admission queue is at ``BatchingSpec.max_queue``: shed at the
    door instead of queueing into a guaranteed timeout (HTTP 429 +
    ``Retry-After`` at the protocol layer)."""

    def __init__(self, message: str, retry_after: float = 1.0,
                 qos: str = QOS_DEFAULT):
        super().__init__(message)
        self.retry_after = retry_after
        self.qos = qos


# -- sampling ------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SamplingParams:
    max_new_tokens: int = 64
    temperature: float = 0.0          # 0 = greedy
    top_k: int = 0                    # 0 = off
    top_p: float = 1.0                # >= 1 = off (nucleus sampling)
    stop_token: Optional[int] = None  # eos


def _mode_for(params_list) -> str:
    """Sampling mode for a dispatch (cheapest program that is exact for
    every slot in it)."""
    if all(p.temperature <= 0.0 for p in params_list):
        return "greedy"
    if all(p.top_k <= 0 and p.top_p >= 1.0 for p in params_list):
        return "plain"
    return "full"


def _categorical(gen: torch.Generator, logits: torch.Tensor) -> torch.Tensor:
    """One draw per row from softmax(logits) by the Gumbel-max trick (the
    form ``jax.random.categorical`` uses), with noise from ``gen``."""
    u = torch.rand(logits.shape, generator=gen, device=logits.device,
                   dtype=torch.float32)
    tiny = torch.finfo(torch.float32).tiny
    g = -torch.log(-torch.log(u.clamp_min(tiny)))
    return torch.argmax(logits + g, dim=-1)


def _sample_batch(logits: torch.Tensor, gen: torch.Generator,
                  temps: torch.Tensor, top_k: torch.Tensor,
                  top_p: torch.Tensor, mode: str = "full") -> torch.Tensor:
    """[B, V] logits -> [B] token ids with PER-SLOT sampling params.

    ``mode`` is the host's fast-path hint: "greedy" skips sampling, "plain"
    draws from the temperature-scaled logits, "full" applies per-slot top-k
    and top-p (one descending sort serves both)."""
    v = logits.shape[-1]
    greedy = torch.argmax(logits, dim=-1)
    if mode == "greedy":
        return greedy
    tscale = torch.clamp(temps, min=1e-6)[:, None]
    if mode == "plain":
        sampled = _categorical(gen, logits / tscale)
        return torch.where(temps > 0, sampled, greedy)
    order = torch.argsort(-logits, dim=-1)                      # [B,V] desc
    sorted_logits = torch.gather(logits, -1, order)
    col = torch.arange(v, device=logits.device)[None, :]
    keep_k = (col < top_k[:, None]) | (top_k <= 0)[:, None]
    scaled = sorted_logits.masked_fill(~keep_k, -1e30) / tscale
    probs = torch.softmax(scaled, dim=-1)
    cum = torch.cumsum(probs, dim=-1) - probs                   # exclusive
    # Exclusive cumsum keeps the first token whenever top_p > 0; col == 0
    # guards a degenerate top_p <= 0 from an all-masked row.
    keep_p = (cum < top_p[:, None]) | (col == 0)
    final = scaled.masked_fill(~keep_p, -1e30)
    draw = _categorical(gen, final)                             # [B]
    sampled = torch.gather(order, -1, draw[:, None])[:, 0]
    return torch.where(temps > 0, sampled, greedy)


# -- device-side steps ---------------------------------------------------------

def _decode_attention(q, ck, cv, lengths, cfg: DecoderConfig):
    """One-token attention over slot caches. q [B,1,H,Dh]; ck/cv
    [B,Smax,KV,Dh]; lengths [B] = position of the token being decoded (its
    K/V were just written there, so attend to kpos <= lengths[b]). The
    head counts are the tensors' (a rank's, under a model axis)."""
    b, smax = ck.shape[0], ck.shape[1]
    heads, kvh = q.shape[2], ck.shape[2]
    qg = q.reshape(b, kvh, heads // kvh, cfg.head_dim)
    scores = torch.einsum("bkgd,bskd->bkgs", qg.float(), ck.float())
    scores = scores * cfg.head_dim ** -0.5
    kpos = torch.arange(smax, device=ck.device)
    mask = kpos[None, :] <= lengths[:, None]                    # [B, Smax]
    scores = scores.masked_fill(~mask[:, None, None, :], -1e30)
    probs = torch.softmax(scores, dim=-1).to(ck.dtype)
    out = torch.einsum("bkgs,bskd->bkgd", probs, cv)
    return out.reshape(b, 1, heads, cfg.head_dim)


def _decode_block(bp, x, positions, lengths, live, cache_k, cache_v,
                  cfg: DecoderConfig, lora=None):
    """One transformer block for a [B,1] decode step against slot caches
    (written in place). ``lora``: one layer's adapter view — each row's
    low-rank delta adds onto the shared projections (adapter index -1 rows
    add an exact zero)."""
    dt = cfg.activation_dtype
    h = L.rmsnorm(x, bp["ln1"], cfg)
    q = L.project(h, L.rank_q(bp["attn"]["wq"], cfg), dt)
    k = L.project(h, L.rank_kv(bp["attn"]["wk"], cfg), dt)
    v = L.project(h, L.rank_kv(bp["attn"]["wv"], cfg), dt)
    if lora is not None:
        q = L.apply_lora_layer(lora, "wq", h, q)
        k = L.apply_lora_layer(lora, "wk", h, k)
        v = L.apply_lora_layer(lora, "wv", h, v)
    q = L.rope(q, positions, cfg.rope_theta)
    k = L.rope(k, positions, cfg.rope_theta)
    bidx = torch.arange(x.shape[0], device=x.device)
    # Dead rows must not change the cache: they rewrite the value already
    # at their position 0 (a slot mid chunked prefill has real KV there).
    widx = torch.where(live, lengths, torch.zeros_like(lengths))
    keep = live[:, None, None]
    cache_k[bidx, widx] = torch.where(keep, k[:, 0], cache_k[bidx, widx])
    cache_v[bidx, widx] = torch.where(keep, v[:, 0], cache_v[bidx, widx])
    attn = _decode_attention(q, cache_k, cache_v, lengths, cfg)
    proj = L.out_project(attn, L.rank_q(bp["attn"]["wo"], cfg, 0), dt)
    if lora is not None:
        proj = L.apply_lora_layer(
            lora, "wo", attn.reshape(attn.shape[0], 1, -1), proj)
    x = x + C.reduce_from_model(proj, model_axis_of(cfg))
    h = L.rmsnorm(x, bp["ln2"], cfg)
    return x + ffn(bp, h, cfg)


def _decode_step(params: Params, cache: dict, tokens: torch.Tensor,
                 lengths: torch.Tensor, live: torch.Tensor,
                 cfg: DecoderConfig, lora=None) -> torch.Tensor:
    """tokens [B] (last sampled), lengths [B] (their positions), live [B]
    (rows whose KV write is real). Returns logits [B,V] fp32; the cache is
    written in place. ``lora``: the packed adapter buffers with the per-row
    ``aidx`` (serve/lora.py)."""
    x = L.embed(params["embed"], tokens[:, None], cfg)   # [B,1,D]
    if cfg.embed_scale:
        x = x * L.embed_scale_value(cfg)
    positions = lengths[:, None]
    for i in range(cfg.n_layers):
        x = _decode_block(layer_view(params["layers"], i), x, positions,
                          lengths, live, cache["k"][i], cache["v"][i], cfg,
                          lora=L.index_layer(lora, i))
    x = L.rmsnorm(x, params["final_norm"], cfg)
    return lm_head(params, x, cfg)[:, 0]


def _decode_multi(params: Params, cache: dict, tokens, lengths, live, temps,
                  top_k, top_p, stop_tokens, budgets, gen: torch.Generator,
                  cfg: DecoderConfig, num_steps: int,
                  sample_mode: str = "full", lora=None):
    """``num_steps`` decode+sample steps with no host synchronisation.

    Every step runs (see the module note); a finished row stays in the
    batch with its KV write masked and its sampled token discarded, so the
    result equals an early-exit loop's. Emitted tokens surface as ``out``
    [B, num_steps] with -1 in never-emitted cells.

    Returns (out, tokens, lengths, live, budgets): the advanced carry is
    the next round's input."""
    b = tokens.shape[0]
    max_len = cache["k"].shape[2]
    out = torch.full((b, num_steps), -1, dtype=torch.int64,
                     device=tokens.device)
    for i in range(num_steps):
        logits = _decode_step(params, cache, tokens, lengths, live, cfg,
                              lora=lora)
        sampled = _sample_batch(logits, gen, temps, top_k, top_p,
                                mode=sample_mode)
        tokens = torch.where(live, sampled, tokens)
        out[:, i] = torch.where(live, sampled, torch.full_like(sampled, -1))
        lengths = torch.where(live, lengths + 1, lengths)
        budgets = torch.where(live, budgets - 1, budgets)
        # The finish rules the host scheduler applies (they must agree, or
        # a slot would stall or over-generate between dispatches).
        live = live & (sampled != stop_tokens) & (budgets > 0) \
            & (lengths + 1 < max_len)
    return out, tokens, lengths, live, budgets


def _chunk_prefill_step(params: Params, cache: dict, tokens: torch.Tensor,
                        slot: int, start: int, cfg: DecoderConfig,
                        valid_len=None, lora=None):
    """Prefill ONE chunk of a prompt into slot ``slot`` at position
    ``start`` (the slot's cache row accumulates KV across chunks; positions
    past the written region stay causally masked). ``valid_len``: the
    chunk's real tokens (its pads claim no MoE expert capacity). Returns
    [C, V] logits."""
    caches = {"k": cache["k"][:, slot:slot + 1],
              "v": cache["v"][:, slot:slot + 1], "len": start}
    logits, _ = decoder_forward(params, tokens, cfg, kv_caches=caches,
                                lora=lora, valid_len=valid_len)
    return logits[0]


def _prefill_step(params: Params, cache: dict, tokens: torch.Tensor,
                  slots: torch.Tensor, lengths: torch.Tensor,
                  cfg: DecoderConfig, attn_impl: str = "xla", lora=None):
    """Prefill N same-bucket prompts in one dispatch (tokens [N, bucket],
    slots/lengths [N]); returns [N, V] last-real-token logits. Runs the
    model forward with a scratch cache (start statically 0 — the marker that
    lets the flash kernel apply), copies the K/V into the slot rows. Each
    row's pads past its length claim no MoE expert capacity."""
    n, bucket = tokens.shape
    shape = (cfg.n_layers, n, bucket, len(L.local_kv_heads(cfg)), cfg.head_dim)
    scratch = {
        "k": torch.zeros(shape, dtype=cfg.activation_dtype,
                         device=tokens.device),
        "v": torch.zeros(shape, dtype=cfg.activation_dtype,
                         device=tokens.device),
        "len": 0,
        "prefill": True,
    }
    logits, filled = decoder_forward(params, tokens, cfg, kv_caches=scratch,
                                     attn_impl=attn_impl, lora=lora,
                                     valid_len=lengths)
    cache["k"][:, slots, :bucket] = filled["k"]
    cache["v"][:, slots, :bucket] = filled["v"]
    return logits[torch.arange(n, device=tokens.device), lengths - 1]


# -- requests ------------------------------------------------------------------

@dataclasses.dataclass
class Request:
    prompt_tokens: list[int]
    params: SamplingParams = dataclasses.field(default_factory=SamplingParams)
    id: str = ""
    arrival: float = dataclasses.field(default_factory=time.monotonic)
    # Monotonic deadline (None = none): the scheduler reaps expired and
    # cancelled requests wherever they live, freeing the slot.
    deadline: Optional[float] = None
    qos: str = QOS_DEFAULT
    # Multi-tenant LoRA (serve/lora.py): the registered adapter this request
    # decodes through (None = base weights). Rides the request's model id
    # ("model" body field / X-Kftpu-Model header); admission acquires a
    # packed-buffer slot and every release path returns the reference.
    adapter: Optional[str] = None
    # Recompute-preemption bookkeeping: output tokens already folded back
    # into prompt_tokens when the slot was preempted.
    resumed_from: int = 0
    # Disaggregated serving (serve/handoff.py). ``handoff_requested``: this
    # prefill-side request stops at the first token and exports its KV
    # instead of decoding (finish_reason="handoff", payload in
    # ``handoff``). ``adopt``: this decode-side request was born from a
    # handoff payload — admission uploads its KV instead of prefilling.
    handoff_requested: bool = False
    handoff: Optional[Any] = None
    adopt: Optional[Any] = None
    # results
    output_tokens: list[int] = dataclasses.field(default_factory=list)
    first_token_time: Optional[float] = None
    finish_time: Optional[float] = None
    finish_reason: Optional[str] = None
    stream: "queue.Queue[Optional[int]]" = dataclasses.field(
        default_factory=queue.Queue)
    done: threading.Event = dataclasses.field(default_factory=threading.Event)
    _cancelled: threading.Event = dataclasses.field(
        default_factory=threading.Event)
    # Tracing: the submitter's span context and the open engine child span
    # (owned by the scheduler). None on both = untraced request.
    trace_parent: Optional[Any] = None
    span: Optional[Any] = None

    @property
    def ttft(self) -> Optional[float]:
        if self.first_token_time is None:
            return None
        return self.first_token_time - self.arrival

    def cancel(self) -> None:
        """Client abandonment; safe from any thread, idempotent."""
        self._cancelled.set()

    @property
    def cancelled(self) -> bool:
        return self._cancelled.is_set()

    def abandon_reason(self, now: Optional[float] = None) -> Optional[str]:
        """Why the scheduler should drop this request, or None to keep it
        (cancellation wins over expiry)."""
        if self._cancelled.is_set():
            return "cancelled"
        if self.deadline is not None and \
                (time.monotonic() if now is None else now) > self.deadline:
            return "deadline"
        return None

    def result(self, timeout: Optional[float] = None) -> list[int]:
        if not self.done.wait(timeout):
            raise TimeoutError(f"request {self.id} not finished")
        return self.output_tokens


def _span_close(req: Request, status: str = "ok", **attrs: Any) -> None:
    if req.span is not None:
        if attrs:
            req.span.set_attrs(**attrs)
        req.span.end(status)
        req.span = None


def _span_open(req: Request, name: str, **attrs: Any) -> None:
    if req.trace_parent is not None:
        req.span = get_tracer().start_span(name, parent=req.trace_parent,
                                           request=req.id, **attrs)


@dataclasses.dataclass
class _Slot:
    request: Request
    length: int           # position of the NEXT token to be written
    last_token: int
    generated: int = 0
    admit_seq: int = 0    # admission order (preemption picks the youngest)


@dataclasses.dataclass
class _Chunking:
    """An in-flight chunked prefill."""
    request: Request
    slot: int
    pos: int              # next prompt position to prefill
    stalls: int = 0       # consecutive page-starved attempts (paged mode)


@dataclasses.dataclass
class _InflightRound:
    """A dispatched-but-unconsumed decode round: its token block's host
    copy, the event after which the copy is complete (None on the CPU),
    and the dispatch-time slot occupants (consumption masks slots whose
    occupant changed while the round ran)."""
    out: torch.Tensor                   # [B, k_steps], host memory
    ready: Optional[Any]
    active: list[tuple[int, "_Slot"]]
    k_steps: int
    gap_ms: Optional[float]


# -- metrics -------------------------------------------------------------------

#: Queue-delay histogram bucket upper bounds (seconds).
QUEUE_DELAY_BUCKETS = (0.005, 0.02, 0.05, 0.1, 0.25, 1.0, 5.0, 30.0)

#: Host-gap histogram bucket upper bounds (seconds): wall time between the
#: previous decode round's results landing on host and the next round's
#: dispatch (0 when the next round was already in flight).
HOST_GAP_BUCKETS = (0.0002, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
                    0.1, 0.5)


class EngineMetrics:
    """Serving metrics: req/s, TTFT and TPOT quantiles, tokens/s, queue
    delay, shedding/reaping counters, per-QoS-class health, the decode hot
    loop's host gap and dispatch depth, and speculative-decoding health
    (acceptance rate, verified tokens per step, draft overhead share)."""

    def __init__(self, window: int = 2048):
        self._lock = threading.Lock()
        self.requests_completed = 0     # guarded_by: _lock
        self.tokens_generated = 0       # guarded_by: _lock
        self.started = time.monotonic()
        self._ttft: list[float] = []    # guarded_by: _lock
        self._tpot: list[float] = []    # guarded_by: _lock
        self._window = window
        # Speculative decoding counters (one round = one slot's part of a
        # verify dispatch).
        self.spec_rounds = 0            # guarded_by: _lock
        self.spec_drafted = 0           # guarded_by: _lock
        self.spec_accepted = 0          # guarded_by: _lock
        self.spec_emitted = 0           # guarded_by: _lock
        self.spec_draft_time = 0.0      # guarded_by: _lock
        self.spec_verify_time = 0.0     # guarded_by: _lock
        self.requests_shed = 0          # guarded_by: _lock
        self.requests_cancelled = 0     # guarded_by: _lock
        self.requests_expired = 0       # guarded_by: _lock
        self.preemptions = 0            # guarded_by: _lock
        # Handoff health: exports leaving a prefill engine, adoptions
        # landing on a decode engine, failed handoffs (no ack: the hold was
        # released without one), relay retries to another decode replica,
        # local recomputes after every replica failed, and the KV bytes
        # shipped and received (pages + scale rows).
        self.handoffs_exported = 0      # guarded_by: _lock
        self.handoffs_adopted = 0       # guarded_by: _lock
        self.handoffs_failed = 0        # guarded_by: _lock
        self.handoffs_retried = 0       # guarded_by: _lock
        self.handoffs_fallback = 0      # guarded_by: _lock
        self.handoff_bytes_exported = 0  # guarded_by: _lock
        self.handoff_bytes_adopted = 0   # guarded_by: _lock
        self._qd_counts = [0] * (len(QUEUE_DELAY_BUCKETS) + 1)  # guarded_by: _lock
        self._qd_sum = 0.0              # guarded_by: _lock
        self._qd_n = 0                  # guarded_by: _lock
        self._qd: list[float] = []      # guarded_by: _lock
        self._qos: dict[str, dict] = {}  # guarded_by: _lock
        self.dispatch_depth = 0         # guarded_by: _lock
        self._hg: list[float] = []      # guarded_by: _lock
        self._hg_counts = [0] * (len(HOST_GAP_BUCKETS) + 1)  # guarded_by: _lock
        self._hg_sum = 0.0              # guarded_by: _lock
        self._hg_n = 0                  # guarded_by: _lock

    def _qos_entry(self, qos: str) -> dict:  # requires_lock: _lock
        e = self._qos.get(qos)
        if e is None:
            e = self._qos[qos] = {
                "completed": 0, "shed": 0, "preempted": 0,
                "ttft": [], "qd": [],
                "qd_counts": [0] * (len(QUEUE_DELAY_BUCKETS) + 1),
                "qd_sum": 0.0, "qd_n": 0,
            }
        return e

    def observe(self, req: Request) -> None:
        with self._lock:
            self.requests_completed += 1
            self.tokens_generated += len(req.output_tokens)
            e = self._qos_entry(req.qos)
            e["completed"] += 1
            if req.ttft is not None:
                self._ttft.append(req.ttft)
                self._ttft = self._ttft[-self._window:]
                e["ttft"].append(req.ttft)
                e["ttft"] = e["ttft"][-self._window:]
            if (req.finish_time is not None and req.first_token_time is not None
                    and len(req.output_tokens) > 1):
                tpot = ((req.finish_time - req.first_token_time)
                        / (len(req.output_tokens) - 1))
                self._tpot.append(tpot)
                self._tpot = self._tpot[-self._window:]

    def note_shed(self, qos: str = QOS_DEFAULT) -> None:
        with self._lock:
            self.requests_shed += 1
            self._qos_entry(qos)["shed"] += 1

    def note_preempted(self, qos: str = QOS_DEFAULT) -> None:
        with self._lock:
            self.preemptions += 1
            self._qos_entry(qos)["preempted"] += 1

    def note_handoff(self, event: str, wire_bytes: int = 0) -> None:
        """One handoff lifecycle event: ``exported`` | ``adopted`` |
        ``retried`` | ``fallback`` | ``failed``; exports and adoptions also
        count their payload's KV wire bytes."""
        with self._lock:
            if event == "exported":
                self.handoffs_exported += 1
                self.handoff_bytes_exported += wire_bytes
            elif event == "adopted":
                self.handoffs_adopted += 1
                self.handoff_bytes_adopted += wire_bytes
            elif event == "retried":
                self.handoffs_retried += 1
            elif event == "fallback":
                self.handoffs_fallback += 1
            else:
                self.handoffs_failed += 1

    def note_abandoned(self, reason: str) -> None:
        with self._lock:
            if reason == "cancelled":
                self.requests_cancelled += 1
            else:
                self.requests_expired += 1

    def observe_queue_delay(self, seconds: float,
                            qos: str = QOS_DEFAULT) -> None:
        with self._lock:
            i = bisect.bisect_left(QUEUE_DELAY_BUCKETS, seconds)
            self._qd_counts[i] += 1
            self._qd_sum += seconds
            self._qd_n += 1
            self._qd.append(seconds)
            self._qd = self._qd[-self._window:]
            e = self._qos_entry(qos)
            e["qd_counts"][i] += 1
            e["qd_sum"] += seconds
            e["qd_n"] += 1
            e["qd"].append(seconds)
            e["qd"] = e["qd"][-self._window:]

    def queue_delay_histogram(self, qos: Optional[str] = None
                              ) -> tuple[list[float], list[int], float, int]:
        """(bucket upper bounds, per-bucket counts incl. +Inf tail, sum,
        count); ``qos`` selects one class's histogram."""
        with self._lock:
            if qos is None:
                return (list(QUEUE_DELAY_BUCKETS), list(self._qd_counts),
                        self._qd_sum, self._qd_n)
            e = self._qos_entry(qos)
            return (list(QUEUE_DELAY_BUCKETS), list(e["qd_counts"]),
                    e["qd_sum"], e["qd_n"])

    def observe_host_gap(self, seconds: float) -> None:
        with self._lock:
            i = bisect.bisect_left(HOST_GAP_BUCKETS, seconds)
            self._hg_counts[i] += 1
            self._hg_sum += seconds
            self._hg_n += 1
            self._hg.append(seconds)
            self._hg = self._hg[-self._window:]

    def note_dispatch_depth(self, depth: int) -> None:
        with self._lock:
            self.dispatch_depth = depth

    def host_gap_histogram(self) -> tuple[list[float], list[int],
                                          float, int]:
        with self._lock:
            return (list(HOST_GAP_BUCKETS), list(self._hg_counts),
                    self._hg_sum, self._hg_n)

    def observe_spec_round(self, drafted: int, accepted: int, emitted: int,
                           draft_s: float, verify_s: float) -> None:
        with self._lock:
            self.spec_rounds += 1
            self.spec_drafted += drafted
            self.spec_accepted += accepted
            self.spec_emitted += emitted
            self.spec_draft_time += draft_s
            self.spec_verify_time += verify_s

    def snapshot(self) -> dict[str, Any]:
        with self._lock:
            elapsed = max(time.monotonic() - self.started, 1e-9)
            out = {
                "requests_completed": self.requests_completed,
                "tokens_generated": self.tokens_generated,
                "requests_per_sec": self.requests_completed / elapsed,
                "tokens_per_sec": self.tokens_generated / elapsed,
                "requests_shed": self.requests_shed,
                "requests_cancelled": self.requests_cancelled,
                "requests_expired": self.requests_expired,
                "preemptions": self.preemptions,
                "handoffs_exported": self.handoffs_exported,
                "handoffs_adopted": self.handoffs_adopted,
                "handoffs_failed": self.handoffs_failed,
                "handoffs_retried": self.handoffs_retried,
                "handoffs_fallback": self.handoffs_fallback,
                "handoff_bytes_exported": self.handoff_bytes_exported,
                "handoff_bytes_adopted": self.handoff_bytes_adopted,
            }
            if self._qd_n:
                out["queue_delay_avg_ms"] = self._qd_sum / self._qd_n * 1e3
            if self._qd:
                out["queue_delay_p95_ms"] = _quantile(self._qd, 0.95) * 1e3
            qos_out: dict[str, dict[str, Any]] = {}
            for cls, e in self._qos.items():
                c: dict[str, Any] = {"completed": e["completed"],
                                     "shed": e["shed"],
                                     "preempted": e["preempted"]}
                if e["ttft"]:
                    c["ttft_p50_ms"] = _quantile(e["ttft"], 0.5) * 1e3
                    c["ttft_p95_ms"] = _quantile(e["ttft"], 0.95) * 1e3
                if e["qd"]:
                    c["queue_delay_p95_ms"] = _quantile(e["qd"], 0.95) * 1e3
                qos_out[cls] = c
            if qos_out:
                out["qos"] = qos_out
            out["dispatch_depth"] = self.dispatch_depth
            if self._hg_n:
                out["host_gap_seconds"] = self._hg_sum
                out["host_gap_p50_ms"] = _quantile(self._hg, 0.5) * 1e3
                out["host_gap_p99_ms"] = _quantile(self._hg, 0.99) * 1e3
            for name, xs in (("ttft", self._ttft), ("tpot", self._tpot)):
                if xs:
                    srt = sorted(xs)
                    out[f"{name}_p50_ms"] = _quantile(srt, 0.5) * 1e3
                    out[f"{name}_p95_ms"] = _quantile(srt, 0.95) * 1e3
                    out[f"{name}_p99_ms"] = _quantile(srt, 0.99) * 1e3
            if self.spec_rounds:
                out["spec_rounds"] = self.spec_rounds
                out["spec_acceptance_rate"] = (
                    self.spec_accepted / max(self.spec_drafted, 1))
                out["spec_tokens_per_step"] = (
                    self.spec_emitted / self.spec_rounds)
                total = self.spec_draft_time + self.spec_verify_time
                out["spec_draft_overhead"] = (
                    self.spec_draft_time / max(total, 1e-9))
            return out


def _to_host_async(t: torch.Tensor):
    """Start ``t``'s copy to host memory; returns (host tensor, event that
    completes with the copy, or None on the CPU)."""
    if t.device.type == "cpu":
        return t, None
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    ev = torch.cuda.Event()
    ev.record()
    return host, ev


def _host_list(t: torch.Tensor) -> list:
    """``t`` as nested Python lists, through one asynchronous copy to pinned
    host memory and a wait for just that copy."""
    host, ready = _to_host_async(t)
    if ready is not None:
        ready.synchronize()
    return host.tolist()


def _fill(dst: torch.Tensor, src: np.ndarray) -> None:
    """Copy a host array (bf16 as its uint16 bits, serve/handoff.py) into a
    CPU tensor: straight through numpy when the dtypes agree (one copy,
    and a read-only wire array is only read), else through a cast."""
    if torch_dtype_of(src) == dst.dtype:
        host_array(dst)[...] = src
    else:
        dst.copy_(to_torch(src))


def _cast_params(tree: Any, device: torch.device,
                 dtype: Optional[torch.dtype]) -> Any:
    if isinstance(tree, dict):
        return {k: _cast_params(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, QuantizedTensor):
        # Already packed (a quantized load): int8 payload and fp32 scales
        # stay as they are.
        return tree.to(device)
    if dtype is not None and tree.is_floating_point():
        return tree.to(device=device, dtype=dtype)
    return tree.to(device=device)


def _check_packed(params: Params, cfg: DecoderConfig, path=()) -> None:
    """Raise unless every leaf ``quantize_params_int8`` packs is packed:
    a tensor-parallel engine's shards cannot be packed here, since a
    row-parallel weight's scales span every rank's rows."""
    if isinstance(params, dict):
        for k, v in params.items():
            _check_packed(v, cfg, path + (k,))
    elif (contraction_dims(path, cfg) is not None
          and not isinstance(params, QuantizedTensor)):
        raise ValueError(
            f"quantize='int8' under a mesh: {'/'.join(path)} is not packed; "
            "pass shards packed whole (serve.storage.load_params(quantize="
            "'int8', mesh=), or quantize_params_int8 before "
            "decoder_layout(cfg, mesh).cut)")


def _phase_cfgs(cfg: DecoderConfig, b: BatchingSpec):
    """(prefill cfg, decode cfg): an MoE model's expert path per phase.
    Prefill runs one request per dispatch, so the model's own path applies
    ("auto"); decode co-batches slots and stays batch-independent on the
    dense path ("auto") or the zero-drop dispatch (capacity factor E caps
    capacity at k x T: nothing can drop)."""
    if not cfg.is_moe:
        return cfg, cfg
    pre = b.moe_prefill_impl
    if pre == "auto":
        pre = cfg.moe_impl
    if pre not in ("dispatch", "dense"):
        raise ValueError(f"unknown moe_prefill_impl {b.moe_prefill_impl!r}")
    dec = b.moe_decode_impl
    if dec in ("auto", "dense"):
        cfg_decode = dataclasses.replace(cfg, moe_impl="dense")
    elif dec == "zero_drop":
        cfg_decode = dataclasses.replace(
            cfg, moe_impl="dispatch", capacity_factor=float(cfg.num_experts))
    else:
        raise ValueError(f"unknown moe_decode_impl {b.moe_decode_impl!r}")
    return dataclasses.replace(cfg, moe_impl=pre), cfg_decode


# -- the engine ----------------------------------------------------------------

def _gather_slot(cache: dict, slot: int, n: int, cfg: DecoderConfig
                 ) -> Optional[list]:
    """A contiguous slot's first ``n`` positions of k and v as new tensors
    ``[L, n, KV, Dh]`` with the whole model's kv heads (a handoff export's
    read; under a model axis the leader gets them, a follower None)."""
    planes = [cache[k][:, slot, :n].clone() for k in ("k", "v")]
    return gather_kv_heads(cfg, planes, axis=2)


def _upload_slot(cache: dict, slot: int, blocks: dict,
                 cfg: DecoderConfig) -> dict:
    """A contiguous slot's first positions ``<- blocks[name]`` (``[L, n,
    KV, Dh]`` with the whole model's kv heads, on the cache's device and
    dtype), each rank keeping its kv heads: a handoff adoption's write."""
    for name, blk in blocks.items():
        cache[name][:, slot, :blk.shape[1]] = L.take_kv_heads(blk, 2, cfg)
    return cache


def _explain(params: Params, cfg: DecoderConfig, handler: str,
             config: dict, tokens: list[int]) -> dict:
    """The explainer ``handler`` on ``tokens``: every rank of a
    tensor-parallel engine computes it on its shards, the leader's answer
    is served."""
    return run_handler(handler, config, tokens, params=params, cfg=cfg)


#: The device calls a tensor-parallel engine's leader sends its followers.
_TP_OPS = {f.__name__: f for f in (
    _prefill_step, _chunk_prefill_step, _decode_multi, _sample_batch,
    paged_chunk_prefill, paged_decode_multi, copy_pages, upload_pages,
    gather_pages, _gather_slot, _upload_slot, _explain)}


def _check_tp(cfg: DecoderConfig, b: BatchingSpec, mesh,
              draft_params) -> None:
    """What a tensor-parallel engine does not run raises here, with the
    ROADMAP item that brings it."""
    from kubeflow_tpu_torch.parallel.sharding import mesh_shape

    other = {a: n for a, n in mesh_shape(mesh).items()
             if a != "model" and n > 1}
    refused = {
        f"mesh axes {other}": ("9e2", bool(other)),
        "speculative decoding": ("9e3", b.speculative.mode != "off"
                                 or draft_params is not None),
        "LoRA adapters": ("9e3", b.lora.max_adapters > 0),
    }
    named = [f"{k} (ROADMAP.md Queue 1 item {item})"
             for k, (item, v) in refused.items() if v]
    if named:
        raise NotImplementedError(
            f"{', '.join(named)} under a tensor-parallel mesh: the port's "
            "TP engine serves dense and MoE models over the model axis "
            "alone, in every role and with the host and remote KV tiers")


class LLMEngine:
    """Slot-based continuous-batching engine over a decoder LLM."""

    def __init__(self, cfg: DecoderConfig,
                 batching: Optional[BatchingSpec] = None, *,
                 params: Optional[Params] = None, seed: int = 0,
                 device: str | torch.device = "cuda", mesh=None,
                 draft_params: Optional[Params] = None):
        """``mesh`` (one process per card, a ``model`` axis): this rank's
        engine of a tensor-parallel one. ``params`` are then this rank's
        shards (``serve.storage.load_params(..., mesh=)``, or
        ``decoder_layout(cfg, mesh).cut`` of a whole tree), under
        ``quantize`` already packed, since a shard's per-channel scales
        are the whole weight's; without ``params`` each leaf is cut as it
        is drawn."""
        self.device = resolve_device(device)
        self.cfg = cfg
        self.batching = batching or BatchingSpec()
        b = self.batching
        tp = None
        if mesh is not None:
            _check_tp(cfg, b, mesh, draft_params)
            tp = C.model_axis(mesh)
        #: This rank's place on the model axis (None: the whole model).
        self.tp = tp
        self._cfg_prefill, self._cfg_decode = _phase_cfgs(
            with_model_axis(cfg, tp), b)
        # The explainers' config: the dense MoE path (serve/explain.py).
        self._cfg_explain = attribution_cfg(with_model_axis(cfg, tp))
        self._kv_heads = len(L.local_kv_heads(self._cfg_decode))
        check_quantize(b.quantize)
        if b.kv_cache_dtype not in (None, "int8"):
            raise ValueError(f"unknown kv_cache_dtype {b.kv_cache_dtype!r}; "
                             "supported: int8")
        self.kv_quant = b.kv_cache_dtype == "int8"
        if self.kv_quant and not b.paged:
            raise ValueError(
                "kv_cache_dtype=int8 requires paged=True (the density win "
                "is the page pool's; the contiguous slot cache pre-reserves "
                "slots x max_seq_len either way)")
        if b.max_seq_len > cfg.max_seq_len:
            raise ValueError("batching.max_seq_len exceeds model max_seq_len")
        if b.host_kv_pages > 0 and not (b.paged and b.enable_prefix_caching):
            raise ValueError(
                "host_kv_pages requires paged=True with prefix caching (the "
                "host tier holds radix-indexed pool pages)")
        self.num_slots = b.max_batch_size
        self.max_len = b.max_seq_len
        self.buckets = sorted(set(
            min(x, self.max_len) for x in b.prefill_buckets)) or [self.max_len]

        wdt = torch_dtype(b.weights_dtype) if b.weights_dtype else None
        if params is None:
            # Under a mesh each leaf is cut to this rank's shards as drawn.
            gen = torch.Generator(self.device).manual_seed(seed)
            self.params = init_decoder_params(
                gen, cfg, dtype=wdt, quantize=b.quantize,
                shard=None if mesh is None
                else decoder_layout(cfg, mesh).cut_leaf)
        else:
            self.params = _cast_params(params, self.device, wdt)
            if b.quantize is not None and mesh is not None:
                _check_packed(self.params, cfg)
            elif b.quantize is not None:
                # After the dtype cast, so the scales quantize the served
                # values (leaves already packed stay as they are).
                self.params = quantize_params_int8(self.params, cfg)
        self.paged = bool(b.paged)
        self.page_size = int(b.page_size)
        self._allocator: Optional[PageAllocator] = None
        self._kvtier: Optional[RadixPrefixIndex] = None  # lockfree: scheduler-confined
        if self.paged:
            pg = self.page_size
            if pg <= 0 or self.max_len % pg:
                raise ValueError("page_size must divide max_seq_len")
            chunk = max(0, int(b.chunked_prefill_tokens)) or pg
            if chunk % pg:
                raise ValueError(
                    "chunked_prefill_tokens must be a multiple of page_size "
                    "in paged mode (chunk boundaries are page boundaries)")
            self._mpp = self.max_len // pg
            self._num_pages = int(b.max_pages or self.num_slots * self._mpp)
            if self._num_pages * pg < self.max_len:
                raise ValueError(
                    "page pool smaller than one max-length sequence")
            pattn = b.paged_attn_impl
            if pattn == "auto":
                pattn = "pallas" if self.device.type == "cuda" else "gather"
            if pattn not in ("gather", "pallas"):
                raise ValueError(
                    f"unknown paged_attn_impl {b.paged_attn_impl!r}; "
                    "one of auto|gather|pallas")
            self.paged_attn_impl = pattn    # resolved (post-auto) impl
            self._allocator = PageAllocator(
                self._num_pages, pg,
                enable_prefix_caching=b.enable_prefix_caching)
            # lockfree: scheduler-confined (host page-table mirror)
            self._table = np.full((self.num_slots, self._mpp), -1, np.int32)
            self._slot_pages: list[list[int]] = [  # lockfree: scheduler-confined
                [] for _ in range(self.num_slots)]
            # One page past the pool: the sink (serve/paged.py) that takes
            # every write the JAX engine drops out of bounds.
            shape = (cfg.n_layers, self._num_pages + 1, pg, self._kv_heads,
                     cfg.head_dim)
            kv_dt = torch.int8 if self.kv_quant else cfg.activation_dtype
            self.cache = {  # lockfree: scheduler-confined (written in place)
                "k": torch.zeros(shape, dtype=kv_dt, device=self.device),
                "v": torch.zeros(shape, dtype=kv_dt, device=self.device),
            }
            if self.kv_quant:
                # Per-token-per-head scales: +4 bytes per token per kv head
                # against the 2x density of the Dh-wide vectors.
                for n in ("ks", "vs"):
                    self.cache[n] = torch.zeros(shape[:-1],
                                                dtype=torch.float32,
                                                device=self.device)
            if (b.enable_prefix_caching and b.prefix_index == "radix"
                    and (tp is None or tp.rank == 0)):
                # A follower keeps no index and no tier: its state is its
                # pool's planes, which the leader's ops read and write.
                # Device work of the index rides the closures below, all
                # enqueued on the scheduler thread in stream order with the
                # dispatches that read their results. The fabric signature
                # is the JAX engine's string: it folds every shape fact a
                # wire blob depends on (fp32 and bf16 pools both say
                # "full"; a blob of another float dtype is cast on upload),
                # so a port and a JAX replica of one model share keys and
                # replicas of different models never adopt each other's.
                fabric_sig = (f"L{cfg.n_layers}.H{cfg.n_kv_heads}"
                              f".D{cfg.head_dim}.P{pg}"
                              f".{'int8' if self.kv_quant else 'full'}")
                self._kvtier = RadixPrefixIndex(
                    self._allocator, pg,
                    host_pages=int(b.host_kv_pages),
                    demote_after_s=float(b.kv_demote_after_s),
                    migrate_batch_pages=int(b.kv_migrate_batch_pages),
                    copy_pages_fn=self._kv_copy_pages,
                    upload_pages_fn=self._kv_upload_pages,
                    fetch_pages_fn=self._kv_fetch_pages,
                    pressure_fn=self._kv_pressure,
                    remote_store=kv_fabric_store(b.remote_kv_root),
                    remote_after_s=b.kv_remote_after_s,
                    remote_deadline_s=b.kv_remote_deadline_s,
                    fabric_sig=fabric_sig)
        else:
            shape = (cfg.n_layers, self.num_slots, self.max_len,
                     self._kv_heads, cfg.head_dim)
            self.cache = {  # lockfree: scheduler-confined (written in place)
                "k": torch.zeros(shape, dtype=cfg.activation_dtype,
                                 device=self.device),
                "v": torch.zeros(shape, dtype=cfg.activation_dtype,
                                 device=self.device),
            }
        self._gen = torch.Generator(self.device).manual_seed(seed + 1)  # lockfree: scheduler-confined
        # Tensor parallelism: the op stream to (or from) the other ranks.
        self._dispatch: Optional[Dispatcher] = None
        if tp is not None:
            self._dispatch = Dispatcher(tp, self.device, _TP_OPS, {
                "params": self.params, "cache": self.cache, "gen": self._gen,
                "cfg_prefill": self._cfg_prefill,
                "cfg_decode": self._cfg_decode,
                "cfg_explain": self._cfg_explain,
                **{f"cache/{k}": v for k, v in self.cache.items()}})

        # Speculative decoding (serve/spec_decode.py): greedy rounds draft k
        # tokens per slot and verify all k + 1 positions in one dispatch.
        spec = b.speculative
        self.spec_mode = spec.mode
        self.spec_k = int(spec.k)
        self._spec_ngram_max = int(spec.ngram_max)
        self._spec_ngram_min = int(spec.ngram_min)
        self._draft_cfg: Optional[DecoderConfig] = None
        self._draft_params: Optional[Params] = None
        if self.spec_mode == "draft_model":
            dconf = dict(spec.draft or {})
            dcfg = preset(dconf.get("preset", "tiny"),
                          **dconf.get("overrides", {}))
            if dcfg.vocab_size != cfg.vocab_size:
                raise ValueError(
                    f"draft model vocab {dcfg.vocab_size} != target vocab "
                    f"{cfg.vocab_size} (drafts are token ids — the two "
                    "must share the tokenizer)")
            if dcfg.max_seq_len < self.max_len:
                dcfg = dataclasses.replace(dcfg, max_seq_len=self.max_len)
            self._draft_cfg = dcfg
            if draft_params is None:
                dgen = torch.Generator(self.device).manual_seed(seed + 2)
                self._draft_params = init_decoder_params(dgen, dcfg,
                                                         dtype=wdt)
            else:
                # The target's own tensors (a self-draft) are shared, not
                # copied, when device and dtype already agree.
                self._draft_params = _cast_params(draft_params, self.device,
                                                  wdt)
            # The draft's own dense slot cache (the draft is small, so
            # slots x max_len of its kv heads is cheap beside a page pool).
            dshape = (dcfg.n_layers, self.num_slots, self.max_len,
                      dcfg.n_kv_heads, dcfg.head_dim)
            self._draft_cache = {  # lockfree: scheduler-confined (written in place)
                "k": torch.zeros(dshape, dtype=dcfg.activation_dtype,
                                 device=self.device),
                "v": torch.zeros(dshape, dtype=dcfg.activation_dtype,
                                 device=self.device),
            }
            # Consumed-context pointer per slot: positions [0, pos) of the
            # true sequence have valid draft KV; reset at (re-)admission.
            self._draft_pos = [0] * self.num_slots  # lockfree: scheduler-confined
            # Catch-up chunk: the largest power of two <= 128 dividing
            # max_len (the JAX engine's C-aligned windows).
            c = min(128, self.max_len)
            while c > 1 and self.max_len % c:
                c //= 2
            self._draft_chunk = max(c, 1)

        self.prefill_batch_max = max(1, int(b.prefill_batch_max))
        self.prefill_batch_token_budget = max(
            0, int(b.prefill_batch_token_budget))
        if cfg.is_moe and self._cfg_prefill.moe_impl == "dispatch":
            # Co-batched prompts would share the expert capacity buffers.
            self.prefill_batch_max = 1
        # In paged mode EVERY admission chunks (chunks write exactly the
        # pages they fill), so chunking cannot be off: 0 means one page.
        self.chunk_size = max(0, int(b.chunked_prefill_tokens))
        if self.paged and (self.chunk_size <= 0
                           or self.chunk_size % self.page_size):
            self.chunk_size = self.page_size
        self._chunkings: list[_Chunking] = []   # lockfree: scheduler-confined
        self.max_concurrent_prefills = max(1, int(b.max_concurrent_prefills))
        self.decode_steps = max(1, int(b.decode_steps))
        self.prefill_interleave_steps = max(1, int(b.prefill_interleave_steps))
        self._preempted: list[Request] = []     # lockfree: scheduler-confined
        self._backlog: list[Request] = []       # lockfree: scheduler-confined
        self._admit_seq = itertools.count()
        # Disaggregated serving (serve/handoff.py): "prefill" submits
        # default to handoff at the first token; "decode" engines adopt
        # payloads through submit_handoff; every role keeps the whole
        # engine (the unified fallback).
        self.role = b.role
        # Exports awaiting their batched copy to host (one per admit round).
        self._pending_exports: list = []        # lockfree: scheduler-confined
        # Pages backing an exported payload, held until the decode side acks
        # (request id -> (request, pages)). Server-thread acks marshal
        # through ``_handoff_release`` and free on the next step.
        self._handoff_holds: dict[str, tuple] = {}  # lockfree: scheduler-confined
        self._handoff_release: "queue.Queue[tuple[str, bool]]" = queue.Queue()
        # Calls from other threads that must join the op stream (a
        # tensor-parallel explanation): (fn, done event, result box). A
        # deque: the scheduler's check of an empty one takes no lock.
        self._calls: collections.deque = collections.deque()
        # The side stream of the copies to host (exports, demotions): they
        # wait on their gather's event instead of holding up decode.
        self._copy_stream = None                # lockfree: scheduler-confined
        # Multi-tenant LoRA (serve/lora.py): the registry owns the packed
        # per-target A/B buffers and the LRU hot-load/evict slot lifecycle;
        # the per-slot assignments map each running request to its packed
        # slot for the batched dispatch.
        self._lora: Optional[AdapterRegistry] = None  # lockfree: scheduler-confined (buffers)
        self._slot_aidx = [-1] * self.num_slots    # lockfree: scheduler-confined
        self._slot_aname: list[Optional[str]] = [  # lockfree: scheduler-confined
            None] * self.num_slots
        if b.lora.max_adapters:
            self._lora = AdapterRegistry(
                cfg, max_adapters=int(b.lora.max_adapters),
                rank=int(b.lora.rank), targets=tuple(b.lora.targets),
                device=self.device)
        self.slots: list[Optional[_Slot]] = [None] * self.num_slots  # lockfree: scheduler-confined
        self._dstate = DecodeState(self.num_slots, self.device,
                                   mpp=self._mpp if self.paged else None)
        self.pipelined = bool(b.pipelined_decode)
        self._rounds: list[_InflightRound] = []  # lockfree: scheduler-confined
        # lockfree: scheduler-confined
        self._pending_first: list[tuple[Request, int, int, torch.Tensor]] = []
        self._last_ready_t: Optional[float] = None  # lockfree: scheduler-confined
        self.decode_rounds = 0          # lockfree: scheduler-confined counter
        self.first_token_fetches = 0    # lockfree: scheduler-confined counter
        self.waiting: "queue.Queue[Request]" = queue.Queue()
        self.metrics = EngineMetrics()
        self.max_queue = max(0, int(b.max_queue))
        self.queue_delay_budget = (None if b.queue_delay_budget is None
                                   else float(b.queue_delay_budget))
        self.qos_policies = dict(b.qos.classes)
        self.qos_preemption = bool(b.qos.preemption)
        self._id_gen = itertools.count()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._wake = threading.Event()
        # None until stop() runs; False = the scheduler thread outlived its
        # join timeout and is leaked.
        self.stopped_clean: Optional[bool] = None
        #: What ended the background scheduler, if anything did.
        self.error: Optional[BaseException] = None

    def _run(self, fn, *args, **kwargs):
        """A device call that reads weights or writes KV: through the
        dispatcher under a model axis (the other ranks run it on their
        shards), directly otherwise."""
        if self._dispatch is None:
            return fn(*args, **kwargs)
        return self._dispatch.call(fn, *args, **kwargs)

    def explain(self, explainer, tokens: list[int]) -> dict:
        """``explainer`` (a ``serve/explain.build_explainer`` result) on
        ``tokens`` with the engine's params, on the dense MoE path. Under a
        model axis it is a dispatched op (every rank computes on its
        shards), run on the scheduler thread, the one sender of the op
        stream, while the calling thread waits."""
        if self._dispatch is None:
            return explainer(tokens, params=self.params,
                             cfg=self._cfg_explain)
        handler, config = handler_of(explainer)
        return self._on_scheduler(lambda: self._run(
            _explain, self.params, self._cfg_explain, handler, config,
            list(tokens)))

    def _on_scheduler(self, fn):
        """``fn()`` on the scheduler thread (here when no loop runs);
        raises what it raised, or the scheduler's error if it stopped."""
        if self._thread is None or threading.current_thread() is self._thread:
            return fn()
        done, box = threading.Event(), {}
        self._calls.append((fn, done, box))
        self._wake.set()
        while not done.wait(timeout=0.5):
            if self.error is not None or self._thread is None:
                raise RuntimeError("the engine's scheduler stopped") \
                    from self.error
        if "error" in box:
            raise box["error"]
        return box["value"]

    def _drain_calls(self) -> int:
        """Run the calls queued by ``_on_scheduler`` (scheduler thread),
        after the step's admissions and decode round. A call's exception
        goes back to its caller."""
        n = 0
        while self._calls:
            fn, done, box = self._calls.popleft()
            try:
                box["value"] = fn()
            except Exception as exc:  # noqa: BLE001 - re-raised by the caller
                box["error"] = exc
            done.set()
            n += 1
        return n

    @property
    def dispatches(self) -> int:
        """Ops sent to the other ranks (the leader) or run for the leader
        (a follower); 0 without a model axis."""
        return 0 if self._dispatch is None else self._dispatch.count

    def follow(self) -> int:
        """A follower rank's loop: run the leader's ops on this rank's
        shards until the leader stops; returns the ops run."""
        if self._dispatch is None or self._dispatch.leader:
            raise RuntimeError("follow() runs on a model-axis rank above 0")
        return self._dispatch.follow()

    def _upload(self, values, dtype: torch.dtype) -> torch.Tensor:
        """Host values → a tensor on the engine's device, through pinned
        memory and without waiting for the device (a blocking copy would
        stall admission behind the decode round in flight)."""
        t = torch.tensor(values, dtype=dtype)
        if self.device.type == "cpu":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def prefill_impl(self, bucket: int) -> str:
        """Attention impl of a bucket's prefill: "auto" runs the flash kernel
        on CUDA for buckets of at least 2048 that are a multiple of 128 (the
        JAX engine's rule, with "on TPU" read as "on CUDA")."""
        impl = self.batching.prefill_attn_impl
        if impl == "auto":
            impl = ("pallas" if self.device.type == "cuda" and bucket >= 2048
                    and bucket % 128 == 0 else "xla")
        return impl

    # -- submission ------------------------------------------------------------

    def queue_depth(self) -> int:
        """Requests waiting for a slot (admission queue + backlog)."""
        return self.waiting.qsize() + len(self._backlog)

    def class_queue_depth(self, qos: str) -> int:
        return (sum(1 for r in list(self.waiting.queue) if r.qos == qos)
                + sum(1 for r in list(self._backlog) if r.qos == qos))

    def _lower_class_waiting(self, qos: str) -> bool:
        p = QOS_PRIORITY[qos]
        return any(QOS_PRIORITY.get(r.qos, p) > p
                   for r in list(self.waiting.queue) + list(self._backlog))

    def kv_pages_in_use(self) -> int:
        """Pages live requests reference right now (0 for the contiguous
        cache). Cached ref-0 prefix content is excluded: it is freely
        evictable capacity, not load. A quiescent engine reports 0."""
        return 0 if self._allocator is None else self._allocator.in_use()

    def kv_pages_cached(self) -> int:
        """Ref-0 pages still holding reusable prefix content."""
        return 0 if self._allocator is None else self._allocator.cached()

    def kv_pages_host(self) -> int:
        """Prefix pages demoted to the host-RAM tier."""
        return 0 if self._kvtier is None else \
            self._kvtier.host_pages_resident()

    def kv_pages_remote(self) -> int:
        """Pages this replica's radix tree indexes in the remote store tier
        (0 when the tier is off)."""
        return 0 if self._kvtier is None else \
            self._kvtier.remote_pages_resident()

    def drain_kv_to_remote(self, timeout_s: float = 10.0) -> int:
        """Scale-down drain: demote and publish every cached prefix this
        engine still holds to the remote tier, so its conversations
        survive the replica leaving the fleet. Call when idle (traffic
        drained first). Returns pages published."""
        if self._kvtier is None:
            return 0
        return self._kvtier.spill_all_to_remote(timeout_s)

    def kv_tier_pressure(self) -> float:
        """The radix index's pool-pressure ratio (>= 1.0 = urgent; 0 for
        flat and contiguous engines)."""
        return 0.0 if self._kvtier is None else float(self._kvtier.pressure())

    def kv_tier_stats(self) -> dict:
        """Radix counters (empty on flat and contiguous engines): hits,
        matched and COW token counts, COW copies, nodes, evictions — the
        /metrics tier series' source."""
        return {} if self._kvtier is None else self._kvtier.snapshot()

    def kv_pool_density(self) -> dict:
        """Paged-pool capacity (empty on contiguous engines): token
        capacity, pool bytes (int8 payload + scale planes when quantized;
        the sink page is not capacity and is not counted) and tokens per
        MiB."""
        if not self.paged:
            return {}
        planes = ("k", "v", "ks", "vs") if self.kv_quant else ("k", "v")
        pool_bytes = sum(self.cache[n][:, 0].nbytes for n in planes) \
            * self._num_pages
        tokens = self._num_pages * self.page_size
        return {
            "quant": int(self.kv_quant),
            "pool_bytes": int(pool_bytes),
            "token_capacity": int(tokens),
            "tokens_per_mib": tokens / (pool_bytes / 2**20),
        }

    def adapters_resident(self) -> list[str]:
        """Adapters hot in the packed buffers: the
        ``kftpu_engine_adapters_resident`` gauge's label set (the router's
        placement signal)."""
        return [] if self._lora is None else self._lora.resident()

    def adapter_stats(self) -> dict:
        """Registry lifecycle counters (empty on LoRA-free engines): the
        /metrics adapter series' source."""
        return {} if self._lora is None else self._lora.snapshot()

    def pending_prefill_tokens(self) -> int:
        """Prompt tokens waiting to be prefilled (queue + backlog + the
        unprefilled tails of in-flight chunkings)."""
        waiting = sum(len(r.prompt_tokens) for r in list(self.waiting.queue))
        backlog = sum(len(r.prompt_tokens) for r in list(self._backlog))
        chunking = sum(max(len(ch.request.prompt_tokens) - ch.pos, 0)
                       for ch in list(self._chunkings))
        return waiting + backlog + chunking

    def submit(self, prompt_tokens: list[int],
               params: Optional[SamplingParams] = None,
               request_id: Optional[str] = None, *,
               deadline: Optional[float] = None,
               trace_parent=None, qos: str = QOS_DEFAULT,
               handoff: Optional[bool] = None,
               adapter: Optional[str] = None) -> Request:
        """Queue one request. ``handoff`` (default: this engine is a
        prefill role) stops the request at its first token and exports its
        KV (finish_reason "handoff"); ``handoff=False`` decodes locally on
        any role. ``adapter`` names a registered LoRA model id: an unknown
        one fails here (``KeyError``, the protocol layers' 404), so the
        scheduler only ever sees registered adapters; the hot-load happens
        at admission, on the scheduler thread."""
        if not prompt_tokens:
            raise ValueError("empty prompt")
        if len(prompt_tokens) >= self.max_len:
            raise ValueError(
                f"prompt length {len(prompt_tokens)} >= max_seq_len {self.max_len}")
        if qos not in QOS_PRIORITY:
            raise ValueError(
                f"unknown QoS class {qos!r}; known: {sorted(QOS_PRIORITY)}")
        if adapter is not None:
            if self._lora is None:
                raise KeyError(
                    f"unknown model {adapter!r}: this engine serves no "
                    "adapters (lora.max_adapters=0)")
            if not self._lora.known(adapter):
                raise KeyError(
                    f"unknown model {adapter!r}: adapter not registered")
            if handoff:
                raise ValueError(
                    "adapter requests cannot hand off (adapter KV has "
                    "no cross-engine placement contract)")
        bad = [t for t in prompt_tokens
               if not 0 <= int(t) < self.cfg.vocab_size]
        if bad:
            raise ValueError(f"token ids outside the vocabulary "
                             f"[0, {self.cfg.vocab_size}): {bad[:4]}")
        pol = self.qos_policies.get(qos)
        if pol is not None and pol.max_queue \
                and self.class_queue_depth(qos) >= pol.max_queue:
            self.metrics.note_shed(qos)
            raise EngineOverloaded(
                f"{qos} admission quota full "
                f"(max_queue={pol.max_queue})", qos=qos)
        if self.max_queue:
            depth = self.queue_depth()
            if depth >= self.max_queue and not self._lower_class_waiting(qos):
                # Shed-lowest-first: the arrival is itself the most
                # sheddable class present, so IT takes the 429.
                self.metrics.note_shed(qos)
                raise EngineOverloaded(
                    f"admission queue full ({depth} >= "
                    f"max_queue={self.max_queue})", qos=qos)
        wants_handoff = (self.role == "prefill" if handoff is None
                         else bool(handoff))
        req = Request(prompt_tokens=list(prompt_tokens),
                      params=params or SamplingParams(),
                      id=request_id or f"req-{next(self._id_gen)}",
                      deadline=deadline, trace_parent=trace_parent, qos=qos,
                      handoff_requested=wants_handoff, adapter=adapter)
        _span_open(req, "engine.queued", prompt_tokens=len(prompt_tokens),
                   qos=qos)
        self.waiting.put(req)
        self._wake.set()
        return req

    def submit_handoff(self, payload, *, deadline: Optional[float] = None,
                       trace_parent=None) -> Request:
        """Adopt a handed-off request (the decode side of
        serve/handoff.py). Its prompt KV arrives in the payload and its
        first token was emitted by the prefill replica; ``prompt_tokens``
        carries ``prompt + [first_token]`` so the slot invariant (the last
        token's KV is not written yet) and recompute preemption hold as for
        a local request. Admission uploads the KV instead of prefilling;
        the request streams from the SECOND token."""
        payload.validate()
        want = "int8" if self.kv_quant else None
        if payload.cache_dtype != want:
            raise ValueError(
                f"handoff cache-dtype mismatch: payload carries "
                f"{payload.cache_dtype or 'full-dtype'} KV, engine pool is "
                f"{want or 'full-dtype'}")
        plen = payload.kv_len
        if plen + 1 >= self.max_len:
            raise ValueError(
                f"handoff KV length {plen} does not fit max_seq_len "
                f"{self.max_len}")
        expect = (self.cfg.n_layers, plen, self.cfg.n_kv_heads,
                  self.cfg.head_dim)
        if tuple(payload.kv_k.shape) != expect:
            raise ValueError(
                f"handoff KV shape {payload.kv_k.shape} != {expect}")
        if payload.qos not in QOS_PRIORITY:
            raise ValueError(f"unknown QoS class {payload.qos!r}")
        params = SamplingParams(
            max_new_tokens=payload.max_new_tokens,
            temperature=payload.temperature, top_k=payload.top_k,
            top_p=payload.top_p, stop_token=payload.stop_token)
        req = Request(
            prompt_tokens=list(payload.prompt_tokens) + [payload.first_token],
            params=params, id=payload.request_id, deadline=deadline,
            trace_parent=trace_parent, qos=payload.qos, adopt=payload)
        _span_open(req, "engine.queued", prompt_tokens=plen, qos=payload.qos,
                   adopted=True)
        self.waiting.put(req)
        self._wake.set()
        return req

    def complete_handoff(self, request_id: str) -> None:
        """The decode side acked: release the exported pages (marshalled to
        the scheduler thread; safe from any thread)."""
        self._handoff_release.put((request_id, True))
        self._wake.set()

    def fail_handoff(self, request_id: str) -> None:
        """The decode side never acked: release the hold and count the
        failure; the caller recomputes (re-submits locally)."""
        self._handoff_release.put((request_id, False))
        self._wake.set()

    # -- scheduler -------------------------------------------------------------

    def _bucket_for(self, n: int) -> int:
        for bkt in self.buckets:
            if n <= bkt:
                return bkt
        return self.max_len

    def _free_slot(self, extra_reserved: frozenset = frozenset()
                   ) -> Optional[int]:
        reserved = {ch.slot for ch in self._chunkings} | extra_reserved \
            | {slot for _, slot, _, _ in self._pending_first}
        for i, s in enumerate(self.slots):
            if s is None and i not in reserved:
                return i
        return None

    def _flush_first_tokens(self) -> int:
        """Sample + fetch every pending first token (chunked-prefill
        completions) in one batch."""
        if not self._pending_first:
            return 0
        items, self._pending_first = self._pending_first, []
        self._sample_first_batch(items)
        return len(items)

    def _sample_first_batch(self, items,
                            stacked: Optional[torch.Tensor] = None) -> None:
        """One sampler call + one host fetch for a batch of first tokens,
        then admit each request into its slot."""
        if stacked is None:
            stacked = torch.stack([it[3] for it in items])
        params_list = [it[0].params for it in items]
        firsts = self._run(
            _sample_batch, stacked, self._gen,
            self._upload([p.temperature for p in params_list], torch.float32),
            self._upload([p.top_k for p in params_list], torch.int64),
            self._upload([p.top_p for p in params_list], torch.float32),
            _mode_for(params_list))
        vals = firsts.tolist()
        self.first_token_fetches += 1
        for j, (req, slot_idx, plen, _) in enumerate(items):
            self._admit_with_token(req, slot_idx, plen, int(vals[j]))

    def _admit_with_token(self, req: Request, slot_idx: int, plen: int,
                          tok: int) -> None:
        if req.trace_parent is not None:
            # prefill → decode. A handoff-bound request opens no decode
            # span: its decode runs on the adopting engine, and the
            # server's handoff span fills the gap in the same trace.
            _span_close(req, prompt_tokens=plen)
            if not req.handoff_requested:
                _span_open(req, "engine.decode", slot=slot_idx)
        if req.first_token_time is None:
            req.first_token_time = time.monotonic()
        req.output_tokens.append(tok)
        req.stream.put(tok)
        # generated counts ALL emitted tokens — on re-admission after a
        # recompute preemption the budget picks up where it left off.
        self.slots[slot_idx] = _Slot(request=req, length=plen,
                                     last_token=tok,
                                     generated=len(req.output_tokens),
                                     admit_seq=next(self._admit_seq))
        # New occupant: its decode state (and, paged, its page-table row)
        # sync as deltas at the next dispatch.
        self._dstate.mark_slot(slot_idx)
        self._dstate.mark_row(slot_idx)
        if self._draft_cfg is not None:
            # Fresh occupant: the draft has consumed none of it yet (its
            # first spec round runs a catch-up prefill).
            self._draft_pos[slot_idx] = 0
        if not self._finish_if_done(slot_idx) and req.handoff_requested:
            # Prefill role: the first token is out and decode remains —
            # export the slot's KV instead of decoding here. The slot
            # leaves ``slots`` before any decode round can include it.
            self._export_handoff(slot_idx)

    def _advance_one(self, ch: _Chunking) -> int:
        """Run ONE chunk of one in-flight chunked prefill. Returns work done
        (0 when page-pool pressure defers the chunk to a later step)."""
        req, slot_idx = ch.request, ch.slot
        C = self.chunk_size
        plen = len(req.prompt_tokens)
        real = min(C, plen - ch.pos)
        chunk = [0] * C
        chunk[:real] = req.prompt_tokens[ch.pos:ch.pos + real]
        if self.paged:
            if not self._ensure_pages(slot_idx, ch.pos + real):
                # Pool pressure. A stalled chunking holds pages the decode
                # preemption cannot see (its slot is None), so two growing
                # prefills could deadlock: after a few starved attempts,
                # abort this one — index what it wrote, release its pages,
                # and requeue through the preempted lane, whose admission
                # gate waits for room for the whole remaining run.
                ch.stalls += 1
                if ch.stalls >= 3:
                    self._chunkings.remove(ch)
                    self._kv_register(req.prompt_tokens, slot_idx, ch.pos)
                    self._release_slot_pages(slot_idx)
                    self._release_slot_adapter(slot_idx)
                    self._preempted.append(req)
                    self.metrics.note_preempted(req.qos)
                return 0    # otherwise retry next scheduler step
            ch.stalls = 0
            # The gather covers the pages this chunk can see (a power of
            # two, as the JAX engine's trace bucket); writes address per
            # token off the table row, so ch.pos may sit mid-page (the
            # radix COW tail resume).
            ctx = context_bucket(ch.pos, C, self.page_size, self._mpp)
            logits = self._run(
                paged_chunk_prefill,
                self.params, self.cache, self._upload([chunk], torch.int64),
                self._upload(self._table[slot_idx].tolist(), torch.int32),
                ch.pos, real, self._cfg_prefill, context_pages=ctx,
                lora=self._lora_rows([self._slot_aidx[slot_idx]]))
        else:
            logits = self._run(
                _chunk_prefill_step,
                self.params, self.cache, self._upload([chunk], torch.int64),
                slot_idx, ch.pos, self._cfg_prefill, valid_len=real,
                lora=self._lora_rows([self._slot_aidx[slot_idx]]))
        ch.pos += real
        if ch.pos >= plen:
            self._chunkings.remove(ch)
            if self.paged:
                # Index the prompt's KV for cross-request reuse — live: the
                # owner keeps decoding while sharers match through these
                # pages (decode writes start at plen, past every claimed
                # position).
                self._kv_register(req.prompt_tokens, slot_idx, plen)
            # Logits row of the prompt's true last token in this chunk.
            self._pending_first.append((req, slot_idx, plen,
                                        logits[real - 1]))
        return 1

    def _advance_chunked(self) -> int:
        """One chunk of EVERY in-flight chunked prefill."""
        return sum(self._advance_one(ch) for ch in list(self._chunkings))

    def _pages_for(self, tokens: int) -> int:
        return -(-min(tokens, self.max_len) // self.page_size)

    def _drain_waiting(self) -> None:
        while True:
            try:
                self._backlog.append(self.waiting.get_nowait())
            except queue.Empty:
                break

    def _fail_request(self, req: Request, reason: str) -> None:
        """Terminal failure with an explicit reason; a submitted request sets
        ``done`` exactly once."""
        if req.done.is_set():
            return
        req.finish_reason = reason
        req.finish_time = time.monotonic()
        _span_close(req, "cancelled" if reason == "cancelled" else "error",
                    finish_reason=reason, tokens=len(req.output_tokens))
        req.stream.put(None)
        req.done.set()
        if reason == "shed":
            self.metrics.note_shed(req.qos)
        elif reason in ("cancelled", "deadline"):
            self.metrics.note_abandoned(reason)

    def _reap_abandoned(self) -> int:
        """Drop cancelled/expired requests wherever they live (slots,
        chunked prefills, the preempted lane, the backlog) and shed backlog
        entries past their queue-delay budget."""
        self._drain_waiting()
        now = time.monotonic()
        n = 0
        for i, s in enumerate(self.slots):
            if s is None:
                continue
            reason = s.request.abandon_reason(now)
            if reason:
                if self._kvtier is not None:
                    # A cancelled conversation's computed KV is still valid
                    # prefix content: index it before release.
                    self._kv_register(self._context_tokens(s), i, s.length)
                self._release_slot_pages(i)
                self._release_slot_adapter(i)
                self.slots[i] = None
                # The device still thinks the row is live: sync next
                # dispatch; a round already in flight is masked at consume.
                self._dstate.mark_slot(i)
                self._fail_request(s.request, reason)
                n += 1
        for ch in list(self._chunkings):
            reason = ch.request.abandon_reason(now)
            if reason:
                self._chunkings.remove(ch)
                self._release_slot_pages(ch.slot)
                self._release_slot_adapter(ch.slot)
                self._fail_request(ch.request, reason)
                n += 1
        # Handoff holds whose request was cancelled or deadlined (the
        # decode side died and the relay gave up) release here: a hold
        # never outlives its request, so a dead server strands no page.
        for rid, (hreq, pages) in list(self._handoff_holds.items()):
            if hreq.abandon_reason(now):
                del self._handoff_holds[rid]
                self._allocator.free(list(reversed(pages)))
                self.metrics.note_handoff("failed")
                n += 1
        for lane in (self._preempted, self._backlog):
            for req in list(lane):
                reason = req.abandon_reason(now)
                if reason is None and lane is self._backlog:
                    budget = self.queue_delay_budget
                    pol = self.qos_policies.get(req.qos)
                    if pol is not None \
                            and pol.queue_delay_budget is not None:
                        budget = pol.queue_delay_budget
                    if budget is not None and now - req.arrival > budget:
                        reason = "shed"
                if reason:
                    lane.remove(req)
                    self._fail_request(req, reason)
                    n += 1
        return n

    def _enforce_queue_bound(self) -> int:
        """Restore the admission bound by shedding the lowest-class,
        youngest waiting request(s)."""
        if not self.max_queue:
            return 0
        self._drain_waiting()
        n = 0
        while len(self._backlog) > self.max_queue:
            victim = max(self._backlog,
                         key=lambda r: (QOS_PRIORITY.get(r.qos, 1),
                                        r.arrival))
            self._backlog.remove(victim)
            self._fail_request(victim, "shed")
            n += 1
        return n

    def _next_admissible(self) -> Optional[Request]:
        """Strict priority across QoS classes, FIFO within a class; within
        a class the preempted lane resumes first — paged, only once the
        pool can hold its entire remaining run, and while it waits nothing
        at its class or below is admitted (the livelock backpressure).
        Fresh paged requests need room for their prompt plus one growth
        page."""
        self._drain_waiting()
        for cls in sorted(QOS_PRIORITY, key=QOS_PRIORITY.get):
            pre = next((r for r in self._preempted if r.qos == cls), None)
            if pre is not None:
                if not self.paged:
                    self._preempted.remove(pre)
                    return pre
                remaining = max(pre.params.max_new_tokens
                                - len(pre.output_tokens), 0)
                if self._allocator.available() >= self._pages_for(
                        len(pre.prompt_tokens) + remaining):
                    self._preempted.remove(pre)
                    return pre
                return None          # backpressure: this class and below wait
            req = next((r for r in self._backlog if r.qos == cls), None)
            if req is None:
                continue
            if self.paged and self._allocator.available() < self._pages_for(
                    len(req.prompt_tokens)) + 1:
                return None          # head-of-line within the priority order
            self._backlog.remove(req)
            self.metrics.observe_queue_delay(
                time.monotonic() - req.arrival, qos=req.qos)
            return req
        return None

    def _admit(self) -> int:
        """Prefill waiting requests into free slots. Returns admissions.
        One-shot admissions group by bucket into batched prefills; long
        prompts take the chunked path."""
        n = self._advance_chunked()
        pending: list[tuple[Request, int, int, int]] = []   # req, slot, plen, bucket
        while True:
            if self.paged and \
                    len(self._chunkings) >= self.max_concurrent_prefills:
                # Chunking slots exhausted: a strictly higher-class arrival
                # may evict the lowest-class in-flight chunking.
                if not self._maybe_preempt_chunking_for_priority():
                    break
            slot_idx = self._free_slot(frozenset(p[1] for p in pending))
            if slot_idx is None:
                if self._maybe_preempt_for_priority():
                    continue
                break
            req = self._next_admissible()
            if req is None:
                break
            if req.adopt is not None:
                # Handed-off request: its KV arrives in the payload —
                # upload instead of prefilling (spans handled inside).
                self._adopt_handoff(req, slot_idx)
                n += 1
                continue
            adapter_hot = self._assign_adapter(req, slot_idx)
            if adapter_hot is None:
                # Adapter-slot backpressure: every packed slot is referenced
                # by a live request — the request went back to the front of
                # the backlog; stop admitting until one drains.
                break
            if self.paged:
                # Paged admission always chunks; the prefix index trims the
                # work to the uncached tail (radix: live sharing and a COW
                # tail, so the resume may start mid-page).
                pages, covered = self._kv_match(req)
                if req.trace_parent is not None:
                    _span_close(req)       # queued →
                    if adapter_hot:
                        # The admission hot-loaded its adapter: the registry
                        # pull and the slot copy as a phase of the trace.
                        _span_open(req, "engine.adapter_load",
                                   adapter=req.adapter)
                        _span_close(req)
                    tier = self._kvtier
                    if tier is not None and tier.last_promoted:
                        # The promotion's upload was enqueued ahead of this
                        # prefill: a near-instant phase on the trace.
                        _span_open(req, "engine.kv_migrate",
                                   direction="promote",
                                   promoted_pages=tier.last_promoted,
                                   cow_tokens=tier.last_cow_tokens)
                        _span_close(req)
                    elif tier is not None and tier.last_cow_tokens:
                        _span_open(req, "engine.kv_migrate",
                                   cow_tokens=tier.last_cow_tokens)
                        _span_close(req)
                    _span_open(req, "engine.prefill", cached_tokens=covered)
                self._release_slot_pages(slot_idx)
                self._slot_pages[slot_idx] = list(pages)
                self._table[slot_idx, :] = -1
                self._table[slot_idx, :len(pages)] = pages
                self._dstate.mark_row(slot_idx)
                ch = _Chunking(req, slot_idx, covered)
                self._chunkings.append(ch)
                n += self._advance_one(ch)
                continue
            if req.trace_parent is not None:
                _span_close(req)
                if adapter_hot:
                    _span_open(req, "engine.adapter_load",
                               adapter=req.adapter)
                    _span_close(req)
                _span_open(req, "engine.prefill")
            plen = len(req.prompt_tokens)
            C = self.chunk_size
            if C and plen > C and -(-plen // C) * C <= self.max_len \
                    and len(self._chunkings) < self.max_concurrent_prefills:
                # Long prompt: every C-wide window must fit inside max_len
                # (else one-shot prefill below).
                ch = _Chunking(req, slot_idx, 0)
                self._chunkings.append(ch)
                n += self._advance_one(ch)
                continue
            pending.append((req, slot_idx, plen, self._bucket_for(plen)))
        n += self._flush_prefills(pending)
        self._flush_first_tokens()
        # Prefill-role exports queued this round: one batched host copy.
        self._flush_handoffs()
        if n:
            # The device just ran prefill work — the next round's host-gap
            # sample would measure admission, not the hot loop.
            self._last_ready_t = None
        return n

    def _flush_prefills(self, pending) -> int:
        """Dispatch accumulated one-shot admissions: same-bucket groups in
        power-of-two sizes capped by ``prefill_batch_max`` and the token
        budget; one batched first-token sample per group. A mid-flush
        failure fails that group loudly and requeues the rest at the front
        of the backlog."""
        n = 0
        by_bucket: dict[int, list] = {}
        for item in pending:
            by_bucket.setdefault(item[3], []).append(item)
        remaining = {id(item): item for item in pending}
        for bucket, items in by_bucket.items():
            cap = self.prefill_batch_max
            if self.prefill_batch_token_budget:
                cap = min(cap, max(1,
                                   self.prefill_batch_token_budget // bucket))
            i = 0
            while i < len(items):
                take = 1
                while take * 2 <= cap and i + take * 2 <= len(items):
                    take *= 2
                group = items[i:i + take]
                i += take
                toks = [req.prompt_tokens + [0] * (bucket - plen)
                        for req, _, plen, _ in group]
                try:
                    last_logits = self._run(
                        _prefill_step, self.params, self.cache,
                        self._upload(toks, torch.int64),
                        self._upload([g[1] for g in group], torch.int64),
                        self._upload([g[2] for g in group], torch.int64),
                        self._cfg_prefill, self.prefill_impl(bucket),
                        lora=self._lora_rows(
                            [self._slot_aidx[g[1]] for g in group]))
                    self._sample_first_batch(
                        [(req, slot_idx, plen, None)
                         for req, slot_idx, plen, _ in group],
                        stacked=last_logits)
                except Exception:
                    for item in group:
                        remaining.pop(id(item), None)
                    for req, slot_idx, _, _ in group:
                        self._release_slot_adapter(slot_idx)
                        self._fail_request(req, "error")
                    # Re-admission re-acquires their adapter references.
                    for item in remaining.values():
                        self._release_slot_adapter(item[1])
                    self._backlog[:0] = [it[0] for it in remaining.values()]
                    raise
                for item in group:
                    remaining.pop(id(item), None)
                n += len(group)
        return n

    # -- disaggregated handoff (serve/handoff.py) ------------------------------

    def _copy_to_host(self, tensors) -> tuple:
        """Enqueue copies of device ``tensors`` into pinned host memory on
        the side stream, after everything the scheduler's stream has
        enqueued so far (the gathers that made them). Returns (host
        tensors, event that completes with the copies). The sources are
        recorded on the side stream, so the caching allocator reuses them
        only after the copies. On the CPU: the tensors themselves, no
        event."""
        if self.device.type != "cuda":
            return tuple(tensors), None
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(self.device)
        side = self._copy_stream
        gathered = torch.cuda.Event()
        gathered.record()
        hosts = []
        with torch.cuda.stream(side):
            side.wait_event(gathered)
            for t in tensors:
                h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                h.copy_(t, non_blocking=True)
                t.record_stream(side)
                hosts.append(h)
            done = torch.cuda.Event()
            done.record(side)
        return tuple(hosts), done

    def _to_device(self, host: torch.Tensor) -> torch.Tensor:
        """A filled (pinned, on CUDA) host buffer on the engine's device,
        without waiting for the device."""
        if self.device.type == "cpu":
            return host
        return host.to(self.device, non_blocking=True)

    def _host_buffer(self, shape, dtype: torch.dtype, *,
                     zeros: bool = True) -> torch.Tensor:
        pin = self.device.type == "cuda"
        if zeros:
            return torch.zeros(shape, dtype=dtype, pin_memory=pin)
        return torch.empty(shape, dtype=dtype, pin_memory=pin)

    def _export_handoff(self, slot_idx: int) -> None:
        """Queue one just-prefilled slot's KV for export: enqueue the
        device-side gather into new tensors now (stream order: it reads the
        slot's KV before any later kernel could overwrite it), copy to host
        batched in ``_flush_handoffs``. Paged ownership moves to the ack
        hold; the slot and its table row clear either way, before any
        decode round can include the slot."""
        s = self.slots[slot_idx]
        req = s.request
        plen = s.length
        cfg = self.cfg
        if self.paged:
            pages = self._slot_pages[slot_idx]
            need = -(-plen // self.page_size)
            ids = self._upload(pages[:need], torch.int64)
            width = need * self.page_size
            planes = [t.reshape((cfg.n_layers, width) + t.shape[3:])
                      for t in self._run(gather_pages, self.cache, ids,
                                         self._cfg_decode)]
            # The slot's page references back the payload until the decode
            # side acks: NOT freed, NOT in the table.
            self._handoff_holds[req.id] = (req, pages)
            self._slot_pages[slot_idx] = []
            self._table[slot_idx, :] = -1
            self._dstate.mark_row(slot_idx)
        else:
            planes = self._run(_gather_slot, self.cache, slot_idx, plen,
                               self._cfg_decode)
        self.slots[slot_idx] = None
        self._dstate.mark_slot(slot_idx)
        self._pending_exports.append((req, planes, plen))

    def _flush_handoffs(self) -> int:
        """ONE batched copy to host for every export queued this admit
        round, then finish each request with its payload attached
        (finish_reason "handoff": the model server relays from there)."""
        if not self._pending_exports:
            return 0
        items, self._pending_exports = self._pending_exports, []
        hosts, ready = self._copy_to_host(
            [t for _, planes, _ in items for t in planes])
        if ready is not None:
            ready.synchronize()
        now = time.monotonic()
        i = 0
        for req, planes, plen in items:
            got = [host_array(t) for t in hosts[i:i + len(planes)]]
            i += len(planes)
            req.handoff = payload_from_export(
                req, got[0], got[1], plen,
                kv_sk=got[2] if len(got) == 4 else None,
                kv_sv=got[3] if len(got) == 4 else None)
            req.finish_reason = "handoff"
            req.finish_time = now
            self.metrics.observe(req)
            self.metrics.note_handoff(
                "exported", wire_bytes=req.handoff.wire_bytes)
            req.stream.put(None)
            req.done.set()
        return len(items)

    def _adopt_handoff(self, req: Request, slot_idx: int) -> None:
        """Admission of a handed-off request: upload its KV into this
        engine's own pool (alloc + one scatter + table row, owner stamped)
        and seed the slot where the prefill side stopped — length = plen,
        last_token = first_token, budget intact."""
        p = req.adopt
        plen = p.kv_len
        if req.trace_parent is not None:
            # queued → decode directly: the prefill phase happened on the
            # exporting engine, in the same trace.
            _span_close(req)
            _span_open(req, "engine.decode", slot=slot_idx, adopted=True)
        cfg = self.cfg
        planes = {"k": p.kv_k, "v": p.kv_v}
        if self.kv_quant:
            planes.update(ks=p.kv_scale_k, vs=p.kv_scale_v)
        if self.paged:
            pg = self.page_size
            need = -(-plen // pg)
            self._release_slot_pages(slot_idx)
            # Pages this pool already holds for the prompt's prefix are
            # adopted by reference; only the uncovered tail uploads. The
            # match is page-aligned (no COW tail): the upload is per page.
            hit, start = self._kv_match(req, allow_cow=False)
            fresh = self._allocator.alloc(need - len(hit), owner=req.id)
            try:
                if fresh:
                    n2 = 1
                    while n2 < len(fresh):
                        n2 *= 2
                    blocks = {}
                    for name, arr in planes.items():
                        # Whole-model kv heads: each rank keeps its own.
                        buf = self._host_buffer(
                            (cfg.n_layers, n2 * pg) + arr.shape[2:],
                            self.cache[name].dtype)
                        _fill(buf[:, :plen - start], arr[:, start:plen])
                        blocks[name] = self._to_device(buf).view(
                            (cfg.n_layers, n2, pg) + arr.shape[2:])
                    # Power-of-two padding: the pad ids aim at the sink.
                    pidx = [self._num_pages] * n2
                    pidx[:len(fresh)] = fresh
                    self._run(upload_pages, self.cache, blocks,
                              self._upload(pidx, torch.int64),
                              self._cfg_decode)
            except Exception:
                # A failed upload must not strand the refs just taken.
                self._allocator.free(fresh)
                self._allocator.free(hit)
                raise
            pages = list(hit) + fresh
            self._slot_pages[slot_idx] = pages
            self._table[slot_idx, :] = -1
            self._table[slot_idx, :need] = pages
            self._dstate.mark_row(slot_idx)
            # The adopted pages hold the prompt's KV: index them, so
            # same-prefix traffic on this engine reuses them (decode writes
            # start at plen, past every claimed position).
            self._kv_register(p.prompt_tokens, slot_idx, plen)
        else:
            blocks = {}
            for name, arr in planes.items():
                buf = self._host_buffer(
                    (cfg.n_layers, plen) + arr.shape[2:],
                    self.cache[name].dtype, zeros=False)
                _fill(buf, arr)
                blocks[name] = self._to_device(buf)
            self._run(_upload_slot, self.cache, slot_idx, blocks,
                      self._cfg_decode)
        self.slots[slot_idx] = _Slot(request=req, length=plen,
                                     last_token=p.first_token, generated=0,
                                     admit_seq=next(self._admit_seq))
        self._dstate.mark_slot(slot_idx)
        self._dstate.mark_row(slot_idx)
        if self._draft_cfg is not None:
            self._draft_pos[slot_idx] = 0
        self.metrics.note_handoff("adopted", wire_bytes=p.wire_bytes)
        self._finish_if_done(slot_idx)

    def _drain_handoff_releases(self) -> int:
        """Apply server-thread acks and aborts on the scheduler thread (the
        allocator's single owner). Returns releases applied."""
        n = 0
        while True:
            try:
                rid, ok = self._handoff_release.get_nowait()
            except queue.Empty:
                break
            hold = self._handoff_holds.pop(rid, None)
            if hold is not None:
                self._allocator.free(list(reversed(hold[1])))
            if not ok:
                self.metrics.note_handoff("failed")
            n += 1
        return n

    # -- paged bookkeeping -----------------------------------------------------

    @staticmethod
    def _context_tokens(s: _Slot) -> list[int]:
        """The slot's true token sequence (prompt + emitted output past any
        preemption fold-back); ``len == s.length + 1`` (the last token's KV
        is not written yet)."""
        req = s.request
        return list(req.prompt_tokens) + req.output_tokens[req.resumed_from:]

    def _kv_copy_pages(self, src, dst) -> None:
        """COW tail copy: pool pages ``dst[i] <- src[i]``, enqueued on the
        stream before the chunk prefill that reads them."""
        self._run(copy_pages, self.cache,
                  self._upload(list(src), torch.int64),
                  self._upload(list(dst), torch.int64))

    def _kv_upload_pages(self, page_ids, k_blocks, v_blocks,
                         sk_blocks=None, sv_blocks=None) -> None:
        """Host→device promotion: per-page blocks (``[L, pg, KV, Dh]``,
        scale rows ``[L, pg, KV]`` for an int8 pool) into ``page_ids``
        through the scatter adoption uses, enqueued on the scheduler's
        stream before the admission's chunk prefill, so stream order makes
        the prefill read the promoted content. One host copy: the blocks
        pack straight into the power-of-two padded buffer (the pad columns
        go to the sink)."""
        if self.kv_quant and sk_blocks is None:
            raise ValueError(
                "int8 pool promotion requires scale blocks (wire v2 blobs) "
                "— got a full-dtype batch")
        n = len(page_ids)
        n2 = 1
        while n2 < n:
            n2 *= 2
        planes = {"k": k_blocks, "v": v_blocks}
        if self.kv_quant:
            planes.update(ks=sk_blocks, vs=sv_blocks)
        blocks = {}
        for name, blks in planes.items():
            # Whole-model kv heads: each rank keeps its own.
            pool = self.cache[name]
            buf = self._host_buffer((pool.shape[0], n2) + blks[0].shape[1:],
                                    pool.dtype, zeros=False)
            for j, blk in enumerate(blks):
                _fill(buf[:, j], blk)
            blocks[name] = self._to_device(buf)
        pidx = [self._num_pages] * n2
        pidx[:n] = page_ids
        self._run(upload_pages, self.cache, blocks,
                  self._upload(pidx, torch.int64), self._cfg_decode)

    def _kv_fetch_pages(self, page_ids):
        """Demotion batch: the device-side gather of the pages' planes into
        new tensors (the pages may free at once: stream order puts every
        later write behind the gather), and their copy to pinned host
        memory on the side stream. Returns (host planes, event): the
        migration thread waits on that event, the scheduler never does.
        An int8 pool returns four planes (k, v, scale_k, scale_v)."""
        ids = self._upload(list(page_ids), torch.int64)
        return self._copy_to_host(self._run(gather_pages, self.cache, ids,
                                            self._cfg_decode))

    def _kv_register(self, tokens, slot_idx: int, n_tokens: int) -> None:
        """Index ``tokens[:n_tokens]``'s written KV for cross-request reuse
        (radix) or hash the full-page prefix (flat), in the slot occupant's
        adapter namespace: KV content is a function of (tokens, model
        variant), so tenants never share pages."""
        if self._allocator is None or n_tokens <= 0:
            return
        ns = self._slot_namespace(slot_idx)
        if self._kvtier is not None:
            self._kvtier.insert(tokens, self._slot_pages[slot_idx], n_tokens,
                                namespace=ns)
        else:
            self._allocator.register_prefix(
                list(tokens)[:n_tokens],
                self._slot_pages[slot_idx][:n_tokens // self.page_size],
                namespace=ns)

    def _kv_match(self, req: Request, *, allow_cow: bool = True
                  ) -> tuple[list[int], int]:
        """Longest reusable prefix of ``req``'s prompt: (pages now owned by
        the request, tokens covered). Radix: live sharing, host-tier
        promotion and, with ``allow_cow``, a sub-page COW tail. The match
        stays inside the request's adapter namespace."""
        ns = req.adapter or ""
        if self._kvtier is not None:
            return self._kvtier.match_and_acquire(req.prompt_tokens,
                                                  owner=req.id,
                                                  allow_cow=allow_cow,
                                                  namespace=ns)
        hit = self._allocator.match_prefix(req.prompt_tokens, owner=req.id,
                                           namespace=ns)
        return list(hit), len(hit) * self.page_size

    # -- multi-tenant LoRA bookkeeping (serve/lora.py) -------------------------

    def _lora_rows(self, aidx) -> Optional[dict]:
        """The packed adapter buffers with a per-row adapter index (a host
        list, uploaded, or a device tensor) for one dispatch; None on a
        LoRA-free engine."""
        if self._lora is None:
            return None
        if not isinstance(aidx, torch.Tensor):
            aidx = self._upload(list(aidx), torch.int64)
        return {**self._lora.buffers, "aidx": aidx}

    def _assign_adapter(self, req: Request,
                        slot_idx: int) -> Optional[bool]:
        """Bind ``req``'s adapter (if any) to the engine slot: acquire a
        packed-buffer slot reference, hot-loading on a miss. Returns the
        hot-load flag (False = already resident, or base traffic), or None
        when every adapter slot is referenced: the request goes back to the
        front of the backlog (admission backpressure)."""
        if req.adapter is None or self._lora is None:
            self._slot_aidx[slot_idx] = -1
            self._slot_aname[slot_idx] = None
            return False
        try:
            aidx, hot = self._lora.acquire(req.adapter, owner=req.id)
        except AdapterSlotsExhausted:
            self._backlog.insert(0, req)
            return None
        self._slot_aidx[slot_idx] = aidx
        self._slot_aname[slot_idx] = req.adapter
        return hot

    def _release_slot_adapter(self, slot_idx: int) -> None:
        """Return the engine slot's adapter reference (every slot-free path
        calls this exactly once; the refcount sanitizer audits the balance
        per owner)."""
        name = self._slot_aname[slot_idx]
        if name is None:
            return
        self._lora.release(name)
        self._slot_aname[slot_idx] = None
        self._slot_aidx[slot_idx] = -1

    def _slot_namespace(self, slot_idx: int) -> str:
        """KV-content namespace of the slot's occupant ("" = base)."""
        return self._slot_aname[slot_idx] or ""

    def _kv_pressure(self) -> float:
        """Pool-pressure ratio (>= 1.0 = urgent): the pool-occupancy rule
        folded with the queue-delay-vs-budget ratio and adapter hot-load
        backpressure (a new tenant waiting on an adapter slot), as the JAX
        engine exports it."""
        alloc = self._allocator
        pool = (alloc.num_pages // 4) / max(alloc.available(), 1)
        qd = 0.0
        if self.queue_delay_budget:
            snap = self.metrics.snapshot()
            qd = (snap.get("queue_delay_p95_ms", 0.0) / 1e3
                  / self.queue_delay_budget)
        lora = getattr(self, "_lora", None)
        adapter = 1.0 if (lora is not None and self._backlog
                          and lora.pending_pressure()) else 0.0
        return max(pool, qd, adapter)

    def _slot_owner(self, slot_idx: int) -> Optional[str]:
        """Request id owning ``slot_idx`` (occupant or in-flight chunked
        prefill): the refcount sanitizer's leak-attribution label."""
        s = self.slots[slot_idx]
        if s is not None:
            return s.request.id
        for ch in self._chunkings:
            if ch.slot == slot_idx:
                return ch.request.id
        return None

    def _ensure_pages(self, slot_idx: int, upto: int) -> bool:
        """Grow ``slot_idx``'s page list to cover positions [0, upto)."""
        need = min(-(-upto // self.page_size), self._mpp)
        have = len(self._slot_pages[slot_idx])
        if need <= have:
            return True
        try:
            new = self._allocator.alloc(need - have,
                                        owner=self._slot_owner(slot_idx))
        except PagePoolExhausted:
            return False
        self._table[slot_idx, have:need] = new
        self._slot_pages[slot_idx].extend(new)
        self._dstate.mark_row(slot_idx)
        return True

    def _release_slot_pages(self, idx: int) -> None:
        if self._allocator is not None and self._slot_pages[idx]:
            # Leaf-first (reversed) release: indexed pages enter the
            # reclaimable LRU children-before-parents, so pool-pressure
            # eviction trims cached subtrees from the leaves.
            self._allocator.free(list(reversed(self._slot_pages[idx])))
            self._slot_pages[idx] = []
            self._table[idx, :] = -1
            self._dstate.mark_row(idx)

    def _preempt_youngest(self, keep: int) -> bool:
        """Page-pressure preemption victim: the youngest slot of the lowest
        running QoS class, never ``keep``."""
        candidates = [(QOS_PRIORITY.get(s.request.qos, 1), s.admit_seq, i)
                      for i, s in enumerate(self.slots)
                      if s is not None and i != keep]
        if not candidates:
            return False
        _, _, idx = max(candidates)
        self._preempt_slot(idx)
        return True

    def _maybe_preempt_chunking_for_priority(self) -> bool:
        """Every chunking slot is held and a STRICTLY higher class waits →
        evict the lowest-class in-flight chunked prefill. Its request
        requeues through the preempted lane with nothing lost (no token was
        emitted yet), and the chunks already written are indexed before
        the pages release, so the resume usually matches straight back."""
        if not self.qos_preemption or not self._chunkings:
            return False
        waiting = self._waiting_priority()
        if waiting is None:
            return False
        ranked = sorted((QOS_PRIORITY.get(ch.request.qos, 1), i)
                        for i, ch in enumerate(self._chunkings))
        vrank, vidx = ranked[-1]
        if vrank <= waiting:
            return False
        ch = self._chunkings[vidx]
        req = ch.request
        if req.trace_parent is not None:
            _span_close(req, preempted=True, chunked=True)
            _span_open(req, "engine.queued", requeued=True)
        if ch.pos:
            self._kv_register(req.prompt_tokens, ch.slot, ch.pos)
        self._chunkings.remove(ch)
        self._release_slot_pages(ch.slot)
        self._release_slot_adapter(ch.slot)
        self._preempted.append(req)
        self.metrics.note_preempted(req.qos)
        return True

    def _preempt_slot(self, idx: int) -> None:
        """Recompute preemption: release the slot's pages and requeue its
        request with prompt + generated-so-far; re-admission recomputes
        (prefix index permitting) and generation resumes."""
        s = self.slots[idx]
        req = s.request
        if req.trace_parent is not None:
            _span_close(req, preempted=True, tokens=len(req.output_tokens))
            _span_open(req, "engine.queued", requeued=True)
        if self._kvtier is not None:
            # The victim's computed KV stays matchable: its re-admission
            # usually matches back to where it stopped.
            self._kv_register(self._context_tokens(s), idx, s.length)
        req.prompt_tokens = list(req.prompt_tokens) \
            + req.output_tokens[req.resumed_from:]
        req.resumed_from = len(req.output_tokens)
        # An adopted request resumes like any other: its prompt now holds
        # the payload's prompt, first token and every decoded token, so
        # re-admission prefills it (the prefix index permitting) instead of
        # adopting the payload's stale KV again.
        req.adopt = None
        self._release_slot_pages(idx)
        self._release_slot_adapter(idx)
        self.slots[idx] = None
        self._dstate.mark_slot(idx)
        self._preempted.append(req)
        self.metrics.note_preempted(req.qos)

    def _waiting_priority(self) -> Optional[int]:
        self._drain_waiting()
        ranks = [QOS_PRIORITY.get(r.qos, 1)
                 for r in self._backlog + self._preempted]
        return min(ranks) if ranks else None

    def _maybe_preempt_for_priority(self) -> bool:
        """Every slot busy and a STRICTLY higher class waits → evict the
        youngest slot of the lowest running class."""
        if not self.qos_preemption:
            return False
        waiting = self._waiting_priority()
        if waiting is None:
            return False
        victims = [(QOS_PRIORITY.get(s.request.qos, 1), s.admit_seq, i)
                   for i, s in enumerate(self.slots) if s is not None]
        if not victims:
            return False
        vrank, _, vidx = max(victims)
        if vrank <= waiting:
            return False
        self._preempt_slot(vidx)
        return True

    def _finish_if_done(self, idx: int) -> bool:
        s = self.slots[idx]
        reason = None
        if s.request.params.stop_token is not None and \
                s.last_token == s.request.params.stop_token:
            reason = "stop"
        elif s.generated >= s.request.params.max_new_tokens:
            reason = "length"
        elif s.length + 1 >= self.max_len:
            reason = "length"
        if reason is None:
            return False
        req = s.request
        req.finish_reason = reason
        req.finish_time = time.monotonic()
        _span_close(req, finish_reason=reason,
                    tokens=len(req.output_tokens))
        req.stream.put(None)
        req.done.set()
        self.metrics.observe(req)
        if self.paged:
            if self._kvtier is not None:
                # Conversation reuse: index prompt + generated tokens (valid
                # KV is ctx[:s.length]) before the pages release, so the
                # next turn matches through prompt and history.
                self._kv_register(self._context_tokens(s), idx, s.length)
            self._release_slot_pages(idx)
        self._release_slot_adapter(idx)
        self.slots[idx] = None
        return True

    def _decode_once(self) -> int:  # hot-loop
        """One decode scheduler pass. Greedy-only batches take the
        speculative path when it is on; otherwise dispatch round N+1 first,
        then consume round N (pipelined), so the host's emit/stream/admit
        work overlaps device compute. Returns work done (tokens emitted +
        dispatches)."""
        active = [(i, s) for i, s in enumerate(self.slots) if s is not None]
        if (self.spec_mode != "off" and active
                and all(s.request.params.temperature <= 0.0
                        for _, s in active)):
            # Spec rounds verify on the host between dispatches: drain the
            # plain pipeline first so the host's slot state is current.
            emitted = self._consume_rounds()
            active = [(i, s) for i, s in enumerate(self.slots)
                      if s is not None]
            if not active:
                return emitted
            return emitted + self._spec_decode_once(active)
        dispatched = self._dispatch_round(active) if active else False
        keep = 1 if (self.pipelined and dispatched) else 0
        emitted = 1 if dispatched else 0
        while len(self._rounds) > keep:
            emitted += self._consume_round()
        return emitted

    def _slot_state_values(self, idx: int) -> tuple:
        """Host-side truth for one slot, in STATE_FIELDS order."""
        s = self.slots[idx]
        if s is None:
            return DEAD_SLOT
        p = s.request.params
        budget = max(p.max_new_tokens - s.generated, 0)
        return (s.last_token, s.length, budget > 0, p.temperature, p.top_k,
                p.top_p, -1 if p.stop_token is None else p.stop_token,
                budget, self._slot_aidx[idx])

    def _steps_left(self, i: int, s: _Slot) -> int:
        """Most decode steps slot ``i`` can still take after the rounds in
        flight: its remaining budget and cache room, less every in-flight
        round it rides (each advances a live slot by its full step count)."""
        p = s.request.params
        left = min(p.max_new_tokens - s.generated,
                   self.max_len - 1 - s.length)
        inflight = sum(r.k_steps for r in self._rounds
                       if any(j == i and occ is s for j, occ in r.active))
        return left - inflight

    def _sync_decode_state(self) -> None:  # hot-loop
        """Write the dirty slots' state and page-table rows to the device."""
        if self._dstate.dirty_slots:
            self._dstate.sync_slots(self._slot_state_values)
        if self._dstate.dirty_rows:
            self._dstate.sync_rows(lambda i: self._table[i])

    def _dispatch_round(self, active) -> bool:  # hot-loop
        """Enqueue one multi-step decode dispatch over the device-resident
        state (no host blocking). Returns False when no active slot has a
        step left after the rounds already in flight."""
        k_steps = (min(self.decode_steps, self.prefill_interleave_steps)
                   if self._chunkings else self.decode_steps)
        k_steps = min(k_steps, max(self._steps_left(i, s) for i, s in active))
        if k_steps <= 0:
            return False
        if self.paged:
            # Pages must cover every live slot's next k_steps write
            # positions PLUS the steps of the rounds in flight (the device
            # may already be that far past the host's lengths), or a
            # mid-dispatch write lands unmapped (on the sink, lost). Under
            # pool pressure, preempt youngest-first.
            slack = sum(r.k_steps for r in self._rounds)
            for i, s in list(active):
                if self.slots[i] is not s:
                    continue    # preempted by an earlier slot's allocation
                upto = min(s.length + slack + k_steps, self.max_len)
                while not self._ensure_pages(i, upto):
                    if self._preempt_youngest(keep=i):
                        continue
                    # Sole survivor: shrink the dispatch to one step (one
                    # max-length sequence always fits the pool).
                    k_steps = 1
                    if not self._ensure_pages(i, min(s.length + slack + 1,
                                                     self.max_len)):
                        self._preempt_slot(i)
                    break
            active = [(i, s) for i, s in enumerate(self.slots)
                      if s is not None]
            if not active:
                return False
            k_steps = min(k_steps,
                          max(self._steps_left(i, s) for i, s in active))
            if k_steps <= 0:
                return False
        mode = _mode_for([s.request.params for _, s in active])
        self._sync_decode_state()
        now = time.monotonic()
        gap = None
        if self._last_ready_t is not None:
            gap = 0.0 if self._rounds else max(0.0, now - self._last_ready_t)
            self.metrics.observe_host_gap(gap)
        self.metrics.note_dispatch_depth(len(self._rounds))
        st = self._dstate.arrays
        if self.paged:
            out, tokens, lengths, live, budgets = self._run(
                paged_decode_multi, self.params,
                {**self.cache, "table": self._dstate.table},
                st["tokens"], st["lengths"], st["live"], st["temps"],
                st["top_k"], st["top_p"], st["stops"], st["budgets"],
                self._gen, self._cfg_decode, k_steps, sample_mode=mode,
                attn_impl=self.paged_attn_impl,
                lora=self._lora_rows(st["adapter"]))
        else:
            out, tokens, lengths, live, budgets = self._run(
                _decode_multi, self.params, self.cache, st["tokens"],
                st["lengths"],
                st["live"], st["temps"], st["top_k"], st["top_p"],
                st["stops"], st["budgets"], self._gen, self._cfg_decode,
                k_steps,
                sample_mode=mode, lora=self._lora_rows(st["adapter"]))
        self._dstate.adopt({**st, "tokens": tokens, "lengths": lengths,
                            "live": live, "budgets": budgets})
        host, ready = _to_host_async(out)
        self.decode_rounds += 1
        self._rounds.append(_InflightRound(
            out=host, ready=ready, active=list(active), k_steps=k_steps,
            gap_ms=None if gap is None else gap * 1e3))
        return True

    def _consume_round(self) -> int:  # hot-loop
        """Emit the oldest in-flight round's tokens. Slots whose occupant
        changed while the round ran are masked. Returns tokens emitted."""
        rnd = self._rounds.pop(0)
        if rnd.ready is not None:
            rnd.ready.synchronize()
        out = rnd.out.tolist()
        self._last_ready_t = time.monotonic()
        emitted = 0
        for i, s in rnd.active:
            if self.slots[i] is not s or s.request.done.is_set():
                continue
            n_emit = 0
            for tok in out[i]:
                if tok < 0:
                    break               # -1 = emitted nothing further
                s.request.output_tokens.append(tok)
                s.request.stream.put(tok)
                s.last_token = tok
                s.length += 1
                s.generated += 1
                n_emit += 1
            emitted += n_emit
            if n_emit and s.request.first_token_time is None:
                # An adopted request's first LOCAL token: this engine's
                # TTFT is its decode-side scheduling latency.
                s.request.first_token_time = time.monotonic()
            if s.request.span is not None and n_emit:
                if rnd.gap_ms is None:
                    s.request.span.add_event("decode_round", tokens=n_emit,
                                             steps=rnd.k_steps)
                else:
                    s.request.span.add_event("decode_round", tokens=n_emit,
                                             steps=rnd.k_steps,
                                             host_gap_ms=round(rnd.gap_ms, 3))
            self._finish_if_done(i)
        return emitted

    def _consume_rounds(self) -> int:
        """Drain every in-flight round (the barrier before a spec round)."""
        emitted = 0
        while self._rounds:
            emitted += self._consume_round()
        return emitted

    def _plain_decode_once(self, active) -> int:  # hot-loop
        """Dispatch and consume one plain round synchronously: the spec
        path's fallback lane (spec rounds verify on the host, so there is
        no pipeline to overlap with here)."""
        self._dispatch_round(active)
        return self._consume_rounds()

    # -- speculative decoding (serve/spec_decode.py) ---------------------------

    def _spec_decode_once(self, active) -> int:  # hot-loop
        """One draft + batched-verify round. Each live slot proposes up to
        ``spec_k`` drafts; ONE dispatch scores all k + 1 positions per slot;
        each slot emits its longest matching draft prefix plus the target's
        token at the first mismatch (identical to plain greedy decode). A
        round in which no slot drafted takes the plain path."""
        t0 = time.monotonic()
        k = self.spec_k
        if self.spec_mode == "ngram":
            drafts = {i: ngram_propose(self._context_tokens(s), k,
                                       self._spec_ngram_max,
                                       self._spec_ngram_min)
                      for i, s in active}
        else:
            drafts = self._draft_model_propose(active)
        if not any(drafts.values()):
            return self._plain_decode_once(active)
        draft_s = time.monotonic() - t0
        t1 = time.monotonic()
        T = k + 1
        if self.paged:
            # Pages must cover ALL T verify write positions (a write on the
            # sink would lose an accepted token's KV). Under pool pressure
            # preempt youngest-first; if even that cannot cover a slot, take
            # the plain path (its one-step shrink handles a sole survivor).
            for i, s in list(active):
                if self.slots[i] is not s:
                    continue    # preempted by an earlier slot's allocation
                upto = min(s.length + T, self.max_len)
                while not self._ensure_pages(i, upto):
                    if not self._preempt_youngest(keep=i):
                        active = [(j, sl) for j, sl in enumerate(self.slots)
                                  if sl is not None]
                        return (self._plain_decode_once(active)
                                if active else 0)
            active = [(i, s) for i, s in enumerate(self.slots)
                      if s is not None]
            if not active:
                return 0
        nb = self.num_slots
        tokens = np.zeros((nb, T), np.int64)
        lengths = np.zeros((nb,), np.int64)
        live = np.zeros((nb,), bool)
        for i, s in active:
            d = drafts.get(i, [])
            tokens[i, 0] = s.last_token
            tokens[i, 1:1 + len(d)] = d
            lengths[i] = s.length
            live[i] = True
        args = (self._upload(tokens, torch.int64),
                self._upload(lengths, torch.int64),
                self._upload(live, torch.bool))
        if self.paged:
            # The verify reads the device-resident page table the plain
            # path owns; dirty rows sync as deltas first.
            self._sync_decode_state()
            greedy = paged_verify_step(
                self.params, {**self.cache, "table": self._dstate.table},
                *args, self._cfg_decode, attn_impl=self.paged_attn_impl)
        else:
            greedy = verify_step(self.params, self.cache, *args,
                                 self._cfg_decode)
        greedy = _host_list(greedy)     # verification happens on the host
        verify_s = time.monotonic() - t1
        emitted = 0
        for i, s in active:
            d = drafts.get(i, [])
            a = 0
            while a < len(d) and d[a] == greedy[i][a]:
                a += 1
            # Accepted drafts + the correction/bonus token from the first
            # position whose match broke. Truncation by budget, stop token
            # or max_len always finishes the slot.
            emit = d[:a] + [greedy[i][a]]
            p = s.request.params
            emit = emit[:max(p.max_new_tokens - s.generated, 0)]
            emit = emit[:self.max_len - 1 - s.length]
            if p.stop_token is not None and p.stop_token in emit:
                emit = emit[:emit.index(p.stop_token) + 1]
            for tok in emit:
                s.request.output_tokens.append(tok)
                s.request.stream.put(tok)
            if emit and s.request.first_token_time is None:
                s.request.first_token_time = time.monotonic()
            if s.request.span is not None and emit:
                s.request.span.add_event("decode_round", spec=True,
                                         drafted=len(d), tokens=len(emit))
            s.last_token = emit[-1]
            s.length += len(emit)
            s.generated += len(emit)
            emitted += len(emit)
            # The slot advanced on the host only: the next plain dispatch
            # resyncs its tokens, lengths and budget.
            self._dstate.mark_slot(i)
            self.metrics.observe_spec_round(
                drafted=len(d), accepted=min(a, len(emit)),
                emitted=len(emit), draft_s=draft_s / len(active),
                verify_s=verify_s / len(active))
            if self.paged:
                # Roll back the rejected positions before the finish can
                # index the context: live KV is exactly [0, s.length).
                self._truncate_slot_pages(i, s.length)
            if self._draft_cfg is not None:
                # Draft KV is valid for all but the last emitted token,
                # which the draft never consumed.
                self._draft_pos[i] = s.length
            self._finish_if_done(i)
        return emitted

    def _draft_model_propose(self, active) -> dict[int, list[int]]:  # hot-loop
        """The draft model's k tokens for every live slot: a catch-up
        through the chunked prefill for slots whose context the draft has
        not consumed (fresh admissions, plain-path rounds), then one
        ``draft_propose`` and one copy of its ids to the host."""
        k = self.spec_k
        dmax = k + 1
        ctxs: dict[int, list[int]] = {}
        for i, s in active:
            ctx = self._context_tokens(s)
            ctxs[i] = ctx
            if len(ctx) - self._draft_pos[i] > dmax:
                # All but the last context token, in windows that end on
                # multiples of the catch-up chunk; only real tokens are fed.
                C = self._draft_chunk
                target = len(ctx) - 1
                pos = self._draft_pos[i]
                while pos < target:
                    real = min(C - pos % C, target - pos)
                    _chunk_prefill_step(
                        self._draft_params, self._draft_cache,
                        self._upload([ctx[pos:pos + real]], torch.int64),
                        i, pos, self._draft_cfg)
                    pos += real
                self._draft_pos[i] = target
        nb = self.num_slots
        deltas = np.zeros((nb, dmax), np.int64)
        dlens = np.zeros((nb,), np.int64)
        dpos = np.zeros((nb,), np.int64)
        live = np.zeros((nb,), bool)
        for i, s in active:
            delta = ctxs[i][self._draft_pos[i]:]
            deltas[i, :len(delta)] = delta
            dlens[i] = len(delta)
            dpos[i] = self._draft_pos[i]
            live[i] = True
        # The JAX engine runs dmax + k - 1 steps (one traced shape); the
        # columns read below end at max(dlens) + k - 2, so the steps past
        # that only wrote draft KV the next round overwrites.
        steps = int(dlens.max()) + k - 1
        out = draft_propose(
            self._draft_params, self._draft_cache,
            self._upload(deltas, torch.int64), self._upload(dlens, torch.int64),
            self._upload(dpos, torch.int64), self._upload(live, torch.bool),
            self._draft_cfg, steps)
        out = _host_list(out)           # drafts are proposed on the host
        drafts: dict[int, list[int]] = {}
        for i, s in active:
            first = int(dlens[i]) - 1    # the step that predicts past ctx
            drafts[i] = out[i][first:first + k]
            # Only the true context counts as consumed; the accepted run
            # advances the pointer after verification.
            self._draft_pos[i] = len(ctxs[i])
        return drafts

    def _truncate_slot_pages(self, idx: int, keep_tokens: int) -> None:
        """Free the pages past those covering [0, keep_tokens): the paged
        rollback after a rejection. Decode-grown pages past the slot's
        length are never indexed, and keep_tokens never rewinds into the
        prompt, so no prefix page is dropped here."""
        keep = -(-keep_tokens // self.page_size)
        pages = self._slot_pages[idx]
        if len(pages) <= keep:
            return
        drop = pages[keep:]
        self._slot_pages[idx] = pages[:keep]
        self._table[idx, keep:len(pages)] = -1
        self._dstate.mark_row(idx)
        self._allocator.free(drop)

    @torch.no_grad()
    def step(self) -> int:
        """One scheduler iteration: reap dead requests, admit, decode.
        Returns work done (a dispatched round counts, so the loop never
        idles with a round in flight)."""
        n = self._reap_abandoned() + self._enforce_queue_bound() \
            + self._drain_handoff_releases() + self._admit()
        if self._kvtier is not None:
            # Host-tier demotion scan: cold cached prefix pages go to the
            # migration thread in batches (interval-gated inside tick; it
            # yields to foreground work unless the pool is under pressure).
            busy = bool(self._backlog) or bool(self._chunkings) \
                or any(s is not None for s in self.slots)
            self._kvtier.tick(busy=busy)
        n += self._decode_once()
        if self._calls:
            n += self._drain_calls()
        if n == 0:
            self._last_ready_t = None
        return n

    # -- background loop -------------------------------------------------------

    def start(self) -> None:
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="llm-engine")
        self._thread.start()

    def _loop(self) -> None:
        try:
            while not self._stop.is_set():
                if self.step() == 0:
                    if self._dispatch is not None:
                        self._dispatch.ping()
                    self._wake.wait(timeout=0.05)
                    self._wake.clear()
        except BaseException as exc:
            # A lost rank of a tensor-parallel engine, or a program error:
            # the server's owner reads it off ``error`` and fails.
            self.error = exc
            logger.exception("engine scheduler stopped")
            raise

    def stop(self, timeout: float = 10.0) -> bool:
        """Stop the background scheduler. Returns (and records in
        ``stopped_clean``) whether the thread actually exited."""
        self._stop.set()
        self._wake.set()
        if self._kvtier is not None:
            self._kvtier.close()
        self.stopped_clean = True
        if self._thread is not None:
            self._thread.join(timeout=timeout)
            if self._thread.is_alive():
                self.stopped_clean = False
                logger.error(
                    "engine scheduler thread did not stop within %.1fs; "
                    "leaking a live thread that still holds device buffers",
                    timeout)
            else:
                self._thread = None
        if (self._dispatch is not None and self._dispatch.leader
                and self._thread is None and self.error is None):
            # Release the followers (the scheduler, their only sender,
            # has ended).
            self._dispatch.close()
        return self.stopped_clean

    # -- convenience -----------------------------------------------------------

    def generate(self, prompt_tokens: list[int],
                 params: Optional[SamplingParams] = None,
                 timeout: float = 120.0) -> list[int]:
        """Blocking single-shot generation (drives steps if no loop runs).
        A timeout cancels the request so the engine frees its slot."""
        req = self.submit(prompt_tokens, params)
        if self._thread is None:
            while not req.done.is_set():
                self.step()
        try:
            return req.result(timeout)
        except TimeoutError:
            req.cancel()
            raise
