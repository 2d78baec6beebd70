"""Multi-tenant LoRA serving: the adapter registry and the batched
multi-adapter dispatch math (port of ``kubeflow_tpu/serve/lora.py``).

One engine serves N rank-r LoRA adapters over one set of shared base
weights:

- **Packed adapter buffers.** Every loaded adapter occupies one slot of a
  packed device buffer per target projection: ``A [L, S, d_in, r]`` and
  ``B [L, S, r, d_out]`` (S = ``LoRASpec.max_adapters`` slots, r = the
  spec's rank cap; lower-rank adapters zero-pad, which leaves ``A @ B``
  exact), plus ``scale [S]`` fp32. The buffers are allocated once on the
  engine's device; a hot-load writes one slot in place (``copy_`` of the
  padded factors), never rebinding or reshaping a buffer, so every
  dispatch sees the same tensors whatever adapters are hot.
- **Batched multi-adapter dispatch.** Each engine slot carries an adapter
  index (device-resident, serve/device_state.py); the decode and prefill
  steps gather each row's slices and apply the low-rank update as one
  gather + two batched products per target (``models/layers.lora_contrib``,
  plain PyTorch: the JAX package computes it outside any Pallas kernel).
  Index -1 multiplies the delta by an exact 0.0, so base rows are
  bit-identical to a LoRA-free engine's.
- **Hot-load / evict.** The registry LRU-loads adapters into slots on
  demand (weights in memory, or pulled from the artifact store at hot-load)
  and evicts only ref-0 adapters; every reference is owner-stamped under
  ``KFTPU_SANITIZE=refcount`` so ``assert_quiescent`` names leakers, as the
  page allocator does.

Adapter blobs are the JAX package's npz layout (``adapter_to_bytes``), so a
blob one package publishes the other reads. Greedy decode under every
adapter equals a single-model engine on the merged weights
(``merged_params``), and the prefix index keys each adapter's KV apart
(tenants never share pages).
"""

from __future__ import annotations

import dataclasses
import io
import logging
import threading
from collections import OrderedDict
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from kubeflow_tpu_torch.device import resolve_device
from kubeflow_tpu_torch.models.config import DecoderConfig
from kubeflow_tpu_torch.models.decoder import Params
from kubeflow_tpu_torch.runtime.sanitize import call_site, enabled

logger = logging.getLogger("kubeflow_tpu_torch.serve.lora")

#: Attention projections LoRA may target.
LORA_TARGETS = ("wq", "wk", "wv", "wo")


class AdapterSlotsExhausted(Exception):
    """Every adapter slot is referenced by a live request: the arrival
    cannot hot-load until one releases. The engine treats this as admission
    backpressure (requeue, not failure), as it does page exhaustion."""


def target_dims(cfg: DecoderConfig, target: str) -> tuple[int, int]:
    """(d_in, d_out) of one attention projection's LoRA factors."""
    d = cfg.hidden
    if target == "wq":
        return d, cfg.n_heads * cfg.head_dim
    if target == "wk" or target == "wv":
        return d, cfg.n_kv_heads * cfg.head_dim
    if target == "wo":
        return cfg.n_heads * cfg.head_dim, d
    raise ValueError(f"unknown LoRA target {target!r}; one of {LORA_TARGETS}")


@dataclasses.dataclass
class AdapterSpec:
    """One registered adapter. ``weights`` maps target -> (A [L, d_in, r],
    B [L, r, d_out]) numpy arrays or tensors; ``source`` is a lazy
    alternative, called once at hot-load (the artifact-store pull path).
    ``alpha`` scales the delta as alpha/rank."""

    name: str
    rank: int
    alpha: float = 16.0
    weights: Optional[dict[str, tuple]] = None
    source: Optional[Callable[[], dict[str, tuple]]] = None

    @property
    def scale(self) -> float:
        return self.alpha / max(self.rank, 1)

    def resolve_weights(self) -> dict[str, tuple]:
        if self.weights is not None:
            return self.weights
        if self.source is None:
            raise ValueError(f"adapter {self.name!r} has no weights/source")
        return self.source()


def _as_tensor(x: Any) -> torch.Tensor:
    """A factor as a torch tensor (numpy arrays share their memory)."""
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(
        np.asarray(x))


def _as_numpy(x: Any) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def init_adapter_weights(gen: torch.Generator, cfg: DecoderConfig, rank: int,
                         targets: Sequence[str] = ("wq", "wv")
                         ) -> dict[str, tuple]:
    """Random nonzero fp32 A/B factors on ``gen``'s device (synthetic
    fine-tunes, the JAX function's scales). Real LoRA training starts B at
    zero; a served adapter has a trained nonzero B, and a zero delta would
    make every token-identity check vacuous, so both factors draw."""
    scale = 0.5
    out: dict[str, tuple] = {}
    for t in targets:
        din, dout = target_dims(cfg, t)
        a = torch.randn((cfg.n_layers, din, rank), generator=gen,
                        device=gen.device) * (scale / np.sqrt(din))
        b = torch.randn((cfg.n_layers, rank, dout), generator=gen,
                        device=gen.device) * (scale / np.sqrt(rank))
        out[t] = (a, b)
    return out


def adapter_delta(weights: dict[str, tuple], target: str, scale: float,
                  device=None) -> Optional[torch.Tensor]:
    """Dense fp32 [L, d_in, d_out] delta of one target (None if the adapter
    does not target it), on ``device`` (default: the factors')."""
    ab = weights.get(target)
    if ab is None:
        return None
    a, b = _as_tensor(ab[0]), _as_tensor(ab[1])
    dev = a.device if device is None else device
    a = a.to(device=dev, dtype=torch.float32)
    b = b.to(device=dev, dtype=torch.float32)
    return torch.einsum("ldr,lro->ldo", a, b) * scale


def merged_params(params: Params, cfg: DecoderConfig,
                  spec: AdapterSpec) -> Params:
    """Base params with ``spec``'s delta folded into the attention weights
    (merged in fp32, cast back to each weight's dtype): the single-model
    reference the multi-adapter dispatch is held to. Every other tensor is
    shared with ``params``, not copied."""
    weights = spec.resolve_weights()
    layers = dict(params["layers"])
    attn = dict(layers["attn"])
    for t in LORA_TARGETS:
        w = attn[t]
        delta = adapter_delta(weights, t, spec.scale, device=w.device)
        if delta is None:
            continue
        attn[t] = (w.float() + delta.reshape(w.shape)).to(w.dtype)
    layers["attn"] = attn
    return {**params, "layers": layers}


# -- artifact-store round trip -------------------------------------------------

def adapter_to_bytes(weights: dict[str, tuple], *, rank: int,
                     alpha: float) -> bytes:
    """Serialize adapter factors as the JAX package's npz blob (the
    artifact-store payload: ``store.put_bytes`` + ``store.register``
    publishes it; ``adapter_spec_from_store`` pulls it back at hot-load)."""
    arrs: dict[str, np.ndarray] = {
        "__meta_rank": np.asarray([rank], np.int32),
        "__meta_alpha": np.asarray([alpha], np.float32),
    }
    for t, (a, b) in weights.items():
        arrs[f"{t}.a"] = _as_numpy(a)
        arrs[f"{t}.b"] = _as_numpy(b)
    buf = io.BytesIO()
    np.savez(buf, **arrs)
    return buf.getvalue()


def adapter_from_bytes(name: str, blob: bytes) -> AdapterSpec:
    with np.load(io.BytesIO(blob)) as z:
        rank = int(z["__meta_rank"][0])
        alpha = float(z["__meta_alpha"][0])
        weights: dict[str, tuple] = {}
        for key in z.files:
            if key.endswith(".a"):
                t = key[:-2]
                weights[t] = (z[f"{t}.a"], z[f"{t}.b"])
    return AdapterSpec(name=name, rank=rank, alpha=alpha, weights=weights)


def adapter_spec_from_store(store, name: str, uri: str, *, rank: int,
                            alpha: float = 16.0) -> AdapterSpec:
    """Registry entry whose weights pull from the artifact store
    (``pipelines/artifacts.py``) at hot-load time, not registration:
    registering a thousand tenants costs a thousand dict entries, not a
    thousand uploads."""

    def source() -> dict[str, tuple]:
        spec = adapter_from_bytes(name, store.get_bytes(store.resolve(uri)))
        return spec.resolve_weights()

    return AdapterSpec(name=name, rank=rank, alpha=alpha, source=source)


# -- the registry --------------------------------------------------------------

class AdapterRegistry:
    """Registered adapters + the packed device buffers their hot slots live
    in.

    Thread contract: ``register``/``known``/``names``/``spec`` are
    thread-safe (the model server's submit path checks membership from
    handler threads); slot state, refcounts and the device buffers are
    scheduler-confined like the page allocator: ``acquire``/``release`` run
    on the engine's scheduler thread only."""

    def __init__(self, cfg: DecoderConfig, *, max_adapters: int,
                 rank: int, targets: Sequence[str] = ("wq", "wv"),
                 device: str | torch.device = "cuda"):
        if max_adapters < 1:
            raise ValueError("max_adapters must be >= 1")
        for t in targets:
            target_dims(cfg, t)                   # validates the name
        self.cfg = cfg
        self.device = resolve_device(device)
        self.max_adapters = int(max_adapters)
        self.rank = int(rank)
        self.targets = tuple(targets)
        dt = cfg.activation_dtype
        self._lock = threading.Lock()
        self._specs: dict[str, AdapterSpec] = {}   # guarded_by: _lock
        # Slot state below: lockfree: scheduler-confined
        self._slot_of: dict[str, int] = {}
        self._name_of: list[Optional[str]] = [None] * self.max_adapters
        self._lru: "OrderedDict[str, None]" = OrderedDict()
        self._refs: dict[str, int] = {}
        self._stamps: dict[str, list[str]] = {}
        self.stats = {"acquires": 0, "hits": 0, "loads": 0,  # lockfree: scheduler-confined
                      "evictions": 0}
        self.refcount_debug = enabled("refcount")
        n_layers, slots = cfg.n_layers, self.max_adapters
        self.buffers: dict[str, Any] = {  # lockfree: scheduler-confined
            "scale": torch.zeros((slots,), dtype=torch.float32,
                                 device=self.device),
            "targets": {},
        }
        for t in self.targets:
            din, dout = target_dims(cfg, t)
            self.buffers["targets"][t] = (
                torch.zeros((n_layers, slots, din, self.rank), dtype=dt,
                            device=self.device),
                torch.zeros((n_layers, slots, self.rank, dout), dtype=dt,
                            device=self.device))

    # -- registration (thread-safe) ----------------------------------------

    def register(self, spec: AdapterSpec) -> AdapterSpec:
        if spec.rank < 1 or spec.rank > self.rank:
            raise ValueError(
                f"adapter {spec.name!r} rank {spec.rank} exceeds the "
                f"engine's packed rank cap {self.rank}")
        with self._lock:
            self._specs[spec.name] = spec
        return spec

    def known(self, name: str) -> bool:
        with self._lock:
            return name in self._specs

    def names(self) -> list[str]:
        with self._lock:
            return list(self._specs)

    # -- observability -----------------------------------------------------

    def resident(self) -> list[str]:
        """Adapters hot in a device slot (the
        ``kftpu_engine_adapters_resident`` series' label set)."""
        return [n for n in self._name_of if n is not None]

    def pending_pressure(self) -> bool:
        """True when every slot is referenced: an arriving new tenant cannot
        hot-load until something drains (the engine folds this into the KV
        tier's pressure signal)."""
        free = sum(1 for n in self._name_of
                   if n is None or self._refs.get(n, 0) == 0)
        return free == 0

    def packed_bytes(self) -> int:
        """Bytes of the packed A/B factor buffers (the scale vector aside)."""
        return sum(a.nbytes + b.nbytes
                   for a, b in self.buffers["targets"].values())

    def snapshot(self) -> dict:
        out = dict(self.stats)
        out["resident"] = len(self._slot_of)
        out["slots"] = self.max_adapters
        return out

    # -- refcount sanitizer -------------------------------------------------

    def _stamp(self, name: str, owner: Optional[str]) -> None:
        label = owner if owner is not None else call_site((__file__,))
        self._stamps.setdefault(name, []).append(label)

    def _unstamp(self, name: str) -> None:
        stamps = self._stamps.get(name)
        if stamps:
            stamps.pop()
            if not stamps:
                del self._stamps[name]

    def leak_report_by_owner(self) -> dict:
        """owner -> outstanding adapter references (refcount mode; {} when
        quiescent)."""
        out: dict[str, int] = {}
        for name, n in self._refs.items():
            if n <= 0:
                continue
            for label in self._stamps.get(name, ()) or ["<unstamped>"]:
                out[label] = out.get(label, 0) + 1
        return out

    def assert_quiescent(self) -> None:
        held = {n: r for n, r in self._refs.items() if r > 0}
        if held:
            msg = f"adapter slot leak: {held}"
            if self.refcount_debug:
                msg += ("; outstanding references by owner: "
                        + ", ".join(f"{o}={n}" for o, n in
                                    sorted(self.leak_report_by_owner()
                                           .items())))
            raise AssertionError(msg)

    # -- acquire / release (scheduler thread) -------------------------------

    def acquire(self, name: str, owner: Optional[str] = None
                ) -> tuple[int, bool]:
        """One reference on ``name``'s slot, hot-loading on miss. Returns
        ``(slot_idx, hot_loaded)``. Raises ``KeyError`` for an unregistered
        name (the protocol layers' 404) and ``AdapterSlotsExhausted`` when
        every slot is referenced (admission backpressure)."""
        with self._lock:
            spec = self._specs.get(name)
        if spec is None:
            raise KeyError(f"unknown model {name!r}: adapter not registered")
        self.stats["acquires"] += 1
        hot = False
        slot = self._slot_of.get(name)
        if slot is None:
            slot = self._load_slot(spec)
            hot = True
        else:
            self.stats["hits"] += 1
        self._refs[name] = self._refs.get(name, 0) + 1
        if self.refcount_debug:
            self._stamp(name, owner)
        self._lru.move_to_end(name)
        return slot, hot

    def release(self, name: str, owner: Optional[str] = None) -> None:
        n = self._refs.get(name, 0) - 1
        assert n >= 0, f"double release of adapter {name!r}"
        self._refs[name] = n
        if self.refcount_debug:
            self._unstamp(name)

    def _padded(self, x: Any, shape: tuple, rank_axis: int) -> torch.Tensor:
        """``x`` zero-padded along ``rank_axis`` to the packed rank, in the
        buffers' dtype, ready to copy into a slot: built where ``x`` lives
        (pinned host memory for a host factor bound for the card)."""
        src = _as_tensor(x)
        dt = self.buffers["targets"][self.targets[0]][0].dtype
        pin = src.device.type == "cpu" and self.device.type == "cuda"
        out = torch.zeros(shape, dtype=dt, device=src.device, pin_memory=pin)
        idx = [slice(None)] * 3
        idx[rank_axis] = slice(0, src.shape[rank_axis])
        out[tuple(idx)] = src
        return out

    def _load_slot(self, spec: AdapterSpec) -> int:
        """Place ``spec`` into a free slot, evicting the LRU ref-0 resident
        if none is free, and copy its padded factors into the packed buffers
        in place (enqueued on the current stream, after every dispatch that
        read the slot's old content)."""
        slot = None
        for i, n in enumerate(self._name_of):
            if n is None:
                slot = i
                break
        if slot is None:
            victim = next((n for n in self._lru
                           if self._refs.get(n, 0) == 0), None)
            if victim is None:
                raise AdapterSlotsExhausted(
                    f"all {self.max_adapters} adapter slots referenced")
            slot = self._slot_of.pop(victim)
            self._lru.pop(victim, None)
            self._name_of[slot] = None
            self.stats["evictions"] += 1
            logger.info("evicting adapter %s (LRU) from slot %d",
                        victim, slot)
        weights = spec.resolve_weights()
        n_layers = self.cfg.n_layers
        updates: dict[str, tuple] = {}
        for t in self.targets:
            din, dout = target_dims(self.cfg, t)
            ab = weights.get(t)
            if ab is None:
                updates[t] = None
                continue
            a, b = _as_tensor(ab[0]), _as_tensor(ab[1])
            if tuple(a.shape) != (n_layers, din, spec.rank) \
                    or tuple(b.shape) != (n_layers, spec.rank, dout):
                raise ValueError(
                    f"adapter {spec.name!r} target {t}: shapes "
                    f"{tuple(a.shape)}/{tuple(b.shape)} do not match "
                    f"{(n_layers, din, spec.rank)}/"
                    f"{(n_layers, spec.rank, dout)}")
            updates[t] = (self._padded(a, (n_layers, din, self.rank), 2),
                          self._padded(b, (n_layers, self.rank, dout), 1))
        # Every check passed: write the slot (all targets, then the scale).
        for t in self.targets:
            pa, pb = self.buffers["targets"][t]
            if updates[t] is None:
                pa[:, slot].zero_()
                pb[:, slot].zero_()
            else:
                pa[:, slot].copy_(updates[t][0], non_blocking=True)
                pb[:, slot].copy_(updates[t][1], non_blocking=True)
        self.buffers["scale"][slot].fill_(float(np.float32(spec.scale)))
        self._slot_of[spec.name] = slot
        self._name_of[slot] = spec.name
        self._lru[spec.name] = None
        self._lru.move_to_end(spec.name)
        self.stats["loads"] += 1
        return slot
