"""Multi-model repository with LRU placement (port of
``kubeflow_tpu/serve/repository.py``).

One card's memory is the scarce resource: the repository keeps registered
models' engines loaded up to a budget (a count and/or estimated bytes) and
evicts least-recently-used engines, whose weights and KV caches free the
card, reloading on demand. Builds are serialized; in-flight requests hold
a lease that pins their entry against eviction, and an unload while leased
lets the leased engine drain and stops it when the last lease releases.

The model server serves the v2 repository API over it:
``GET /v2/repository/index``, ``POST /v2/repository/models/{m}/load`` and
``.../unload``.
"""

from __future__ import annotations

import dataclasses
import gc
import logging
import threading
from collections import OrderedDict
from typing import Any, Callable, Optional

import torch

from kubeflow_tpu_torch.models.config import DecoderConfig
from kubeflow_tpu_torch.ops.quantization import packed_param_bytes_estimate
from kubeflow_tpu_torch.serve.engine import LLMEngine
from kubeflow_tpu_torch.serve.lora import target_dims
from kubeflow_tpu_torch.serve.tokenizer import Tokenizer, get_tokenizer

logger = logging.getLogger("kubeflow_tpu_torch.serve")


def estimate_model_bytes(cfg: DecoderConfig, batching=None) -> int:
    """Weights (weight dtype, or int8-packed when the batching spec
    quantizes, with 10% headroom) + the engine's KV cache at
    ``max_batch_size x max_seq_len`` (int8 pools price 1 byte per element
    plus a 4-byte scale per token and kv head) + the packed LoRA buffers
    when the engine serves adapters (``max_adapters`` slots of rank-r A/B
    factors per target). The JAX package's formula: the same inputs give
    the same integer."""
    if batching is not None and getattr(batching, "quantize", None):
        param_bytes = packed_param_bytes_estimate(cfg)
    else:
        param_bytes = cfg.num_params() * cfg.weight_dtype.itemsize
    kv_bytes = 0
    lora_bytes = 0
    if batching is not None:
        kv_tokens = (2 * cfg.n_layers * batching.max_batch_size
                     * batching.max_seq_len * cfg.n_kv_heads)
        if getattr(batching, "kv_cache_dtype", None) == "int8":
            kv_bytes = kv_tokens * (cfg.head_dim + 4)
        else:
            kv_bytes = (kv_tokens * cfg.head_dim
                        * cfg.activation_dtype.itemsize)
        lora = getattr(batching, "lora", None)
        if lora is not None and lora.max_adapters:
            per_slot = sum(
                (din + dout) * lora.rank
                for din, dout in (target_dims(cfg, t)
                                  for t in lora.targets))
            lora_bytes = (cfg.n_layers * lora.max_adapters * per_slot
                          * cfg.activation_dtype.itemsize)
    return int(param_bytes * 1.1) + kv_bytes + lora_bytes


@dataclasses.dataclass
class ModelEntry:
    name: str
    cfg: DecoderConfig
    make_engine: Callable[[], LLMEngine]
    tokenizer: Tokenizer
    bytes: int
    engine: Optional[LLMEngine] = None   # None = registered but not loaded
    refs: int = 0                        # in-flight requests holding a lease
    #: engines detached by unload while leased: stopped when refs hit 0
    draining: list = dataclasses.field(default_factory=list)

    @property
    def state(self) -> str:
        return "READY" if self.engine is not None else "UNLOADED"


class ModelRepository:
    """Thread-safe LRU of loaded engines under a capacity budget.

    Loads are serialized (``_load_lock``): building an engine takes seconds
    and a double build on racing first requests would bust the budget.
    In-flight requests hold a lease on their entry; eviction skips leased
    engines (temporarily exceeding the budget beats killing live requests).
    Engines are built on ``device`` (default ``"cuda"``)."""

    def __init__(self, *, max_loaded: int = 2,
                 max_bytes: Optional[int] = None,
                 device: str | torch.device = "cuda"):
        self.max_loaded = max_loaded
        self.max_bytes = max_bytes
        self.device = device
        self._lock = threading.Lock()
        self._load_lock = threading.Lock()
        self._entries: "OrderedDict[str, ModelEntry]" = OrderedDict()

    # -- registration ----------------------------------------------------------

    def register(self, name: str, cfg: DecoderConfig, *,
                 make_engine: Optional[Callable[[], LLMEngine]] = None,
                 tokenizer: Optional[Tokenizer] = None,
                 batching=None) -> ModelEntry:
        if make_engine is None:
            def make_engine(cfg=cfg, batching=batching):
                return LLMEngine(cfg, batching, device=self.device)

        entry = ModelEntry(
            name=name, cfg=cfg, make_engine=make_engine,
            tokenizer=tokenizer or get_tokenizer("byte"),
            bytes=estimate_model_bytes(cfg, batching))
        with self._lock:
            self._entries[name] = entry
        return entry

    def names(self) -> list[str]:
        with self._lock:
            return list(self._entries)

    def index(self) -> list[dict[str, Any]]:
        with self._lock:
            entries = list(self._entries.values())
        out = []
        for e in entries:
            row: dict[str, Any] = {"name": e.name, "state": e.state,
                                   "bytes": e.bytes}
            # Multi-tenant LoRA: a loaded engine's hot adapters, the
            # variants this replica serves without a hot-load.
            engine = e.engine
            if engine is not None and engine._lora is not None:
                row["adapters_resident"] = engine.adapters_resident()
            out.append(row)
        return out

    def peek(self, name: str) -> Optional[ModelEntry]:
        """Entry without loading or touching LRU recency (metadata and
        metrics)."""
        with self._lock:
            return self._entries.get(name)

    # -- load/unload/eviction --------------------------------------------------

    def _loaded_locked(self) -> list[ModelEntry]:
        return [e for e in self._entries.values() if e.engine is not None]

    def _evict_for_locked(self, incoming: ModelEntry
                          ) -> list[tuple[ModelEntry, LLMEngine]]:
        """LRU-evict (OrderedDict order = recency, oldest first) until the
        incoming model fits, skipping leased entries. Detaches the victims'
        engines under the lock; the caller stops them outside it."""
        victims: list[tuple[ModelEntry, LLMEngine]] = []

        def over() -> bool:
            loaded = self._loaded_locked()
            if len(loaded) + 1 > self.max_loaded:
                return True
            if self.max_bytes is not None:
                used = sum(e.bytes for e in loaded)
                return used + incoming.bytes > self.max_bytes
            return False

        for e in list(self._entries.values()):      # oldest-touched first
            if not over():
                break
            if e.engine is not None and e.name != incoming.name \
                    and e.refs == 0:
                engine, e.engine = e.engine, None
                victims.append((e, engine))
        return victims

    def load(self, name: str) -> LLMEngine:
        """Load (or touch) a registered model; may evict idle LRU engines."""
        with self._lock:
            if name not in self._entries:
                raise KeyError(f"model {name!r} is not registered")
            entry = self._entries[name]
            self._entries.move_to_end(name)         # touch (most recent)
            if entry.engine is not None:
                return entry.engine
        # Serialize builds: a racing first request must not double-build.
        with self._load_lock:
            with self._lock:
                if entry.engine is not None:        # loaded while we waited
                    return entry.engine
                victims = self._evict_for_locked(entry)
            for v, victim in victims:
                logger.info("evicting model %s (LRU)", v.name)
                victim.stop()
            if victims:
                # The victims' weights and caches free before the build: an
                # engine's tier closures form reference cycles, so collect.
                victims = victim = None
                gc.collect()
            engine = entry.make_engine()
            engine.start()
            with self._lock:
                entry.engine = engine
        logger.info("loaded model %s (%.1f MB est.)", name,
                    entry.bytes / 1e6)
        return engine

    def unload(self, name: str) -> None:
        """Detach the model. Leased in-flight requests keep their engine
        alive (it drains and stops when the last lease releases): an unload
        never kills live requests, as LRU eviction does not."""
        with self._lock:
            entry = self._entries.get(name)
            if entry is None:
                raise KeyError(f"model {name!r} is not registered")
            engine, entry.engine = entry.engine, None
            if engine is not None and entry.refs > 0:
                entry.draining.append(engine)
                engine = None
        if engine is not None:
            engine.stop()

    def acquire(self, name: str) -> ModelEntry:
        """Lease an entry for one request: loads on demand and pins the
        engine against eviction until ``release()``."""
        while True:
            self.load(name)
            with self._lock:
                entry = self._entries[name]
                if entry.engine is not None:
                    entry.refs += 1
                    return entry
            # Unloaded between the load and the lease: load again.

    def release(self, entry: ModelEntry) -> None:
        drained: list = []
        with self._lock:
            entry.refs = max(0, entry.refs - 1)
            if entry.refs == 0 and entry.draining:
                drained, entry.draining = entry.draining, []
        for engine in drained:
            engine.stop()

    def shutdown(self) -> None:
        for name in self.names():
            try:
                self.unload(name)
            except KeyError:
                pass
