"""Paged-KV handoff between a prefill-role and a decode-role engine — the
port of ``kubeflow_tpu/serve/handoff.py`` (its wire format, byte for byte).

A prefill engine stops a request at its first token and exports the
prompt's KV; a decode engine adopts that KV into its own pool and decodes
from the second token on. The page is the transfer unit: the exporting
side gathers the slot's pages on the device and copies them to host memory
once per admit round; the adopting side allocates fresh pages in its own
``PageAllocator`` (owner-stamped) and uploads them with one scatter.

Ownership protocol:

1. **Export** (prefill engine, scheduler thread): the first token is
   sampled, the slot's KV is copied to host, and the slot frees — but its
   page references move to a HOLD keyed by request id, not to the free
   list. They back the payload until the decode side acknowledges it.
2. **Ack** (prefill model server): the decode replica answered the handoff
   POST with 200, so the payload is in its memory and the hold is released
   (``engine.complete_handoff``, marshalled onto the scheduler thread).
3. **Failure = recompute**: no ack (connect failure, 409, 5xx, a dead
   peer) means ``engine.fail_handoff`` frees the hold and the server
   re-submits the request locally. A hold whose request is cancelled or
   past its deadline is reaped by the scheduler, so a dead server strands
   no page.

Adoption seeds the decode slot exactly where ``_admit_with_token`` would
have left it: ``length = plen``, ``last_token = first_token``, and the
request's ``prompt_tokens`` carry ``prompt + [first_token]``. Greedy
outputs are therefore token-identical to the unified path.

Wire format: one JSON metadata line + raw little-endian K bytes + V bytes.
Wire v2 (int8 pools) tags ``cache_dtype`` and appends the per-token-per-head
fp32 scale rows (``K + V + scale_K + scale_V``). A v1 blob carries no tag
and decodes with no scales.

**bfloat16.** The JAX package tags bf16 planes ``"bfloat16"`` and decodes
them through ``ml_dtypes``. numpy has no bf16 and the port does not use
``ml_dtypes``, so here a bf16 plane travels as a ``uint16`` array holding
the same bits (``host_array`` / ``to_torch`` convert at the torch
boundary) and keeps the ``"bfloat16"`` tag: the bytes equal the JAX
encoder's, and a payload of either package is adopted by the other. No KV
plane is ever genuinely ``uint16``, so the carrier is unambiguous.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional

import numpy as np
import torch

#: The wire tag of bf16 planes and the numpy dtype that carries their bits.
BF16 = "bfloat16"
_CARRIER = np.dtype(np.uint16)


def _np_dtype(name: str) -> np.dtype:
    """numpy dtype of a wire tag (``bfloat16`` → its uint16 carrier)."""
    if name == BF16:
        return _CARRIER
    try:
        return np.dtype(name)
    except TypeError as exc:
        raise ValueError(f"unsupported KV dtype on the wire: {name!r}") \
            from exc


def _wire_name(a: np.ndarray) -> str:
    return BF16 if a.dtype == _CARRIER else str(a.dtype)


def host_array(t: torch.Tensor) -> np.ndarray:
    """A CPU tensor's values as a numpy array, bf16 as its uint16 bits
    (a view where torch allows one)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(_CARRIER)
    return t.numpy()


def torch_dtype_of(a: np.ndarray) -> torch.dtype:
    """The torch dtype a host array stands for (uint16 = bf16)."""
    if a.dtype == _CARRIER:
        return torch.bfloat16
    return torch.from_numpy(np.zeros(0, a.dtype)).dtype


def to_torch(a: np.ndarray) -> torch.Tensor:
    """A host array as a new CPU tensor of the dtype it stands for (one
    copy: wire arrays are read-only views of the payload bytes)."""
    t = torch.from_numpy(np.array(a))
    return t.view(torch.bfloat16) if a.dtype == _CARRIER else t


@dataclasses.dataclass
class HandoffPayload:
    """One prefilled request's transferable state: identity, sampling
    contract, and the prompt's KV as contiguous host arrays
    ``[L, plen, KV, Dh]`` (the adopting pool re-imposes its own pages)."""

    request_id: str
    prompt_tokens: list[int]        # the plen tokens whose KV rides along
    first_token: int                # sampled on the prefill side (TTFT)
    max_new_tokens: int             # REMAINING decode budget (>= 1)
    temperature: float
    top_k: int
    top_p: float
    stop_token: Optional[int]
    qos: str
    kv_k: np.ndarray
    kv_v: np.ndarray
    # int8 pools only (wire v2): per-token-per-head f32 scales
    # ``[L, plen, KV]``.
    kv_scale_k: Optional[np.ndarray] = None
    kv_scale_v: Optional[np.ndarray] = None

    @property
    def kv_len(self) -> int:
        return int(self.kv_k.shape[1])

    @property
    def cache_dtype(self) -> Optional[str]:
        """"int8" when scales ride along; None = full-dtype KV."""
        return "int8" if self.kv_scale_k is not None else None

    @property
    def wire_bytes(self) -> int:
        """KV bytes as they ride the wire (pages + scale rows, metadata
        line excluded)."""
        n = self.kv_k.nbytes + self.kv_v.nbytes
        if self.kv_scale_k is not None:
            n += self.kv_scale_k.nbytes + self.kv_scale_v.nbytes
        return n

    def validate(self) -> None:
        if self.kv_k.shape != self.kv_v.shape:
            raise ValueError("kv_k/kv_v shape mismatch")
        if self.kv_k.ndim != 4:
            raise ValueError(
                f"KV must be [L, plen, KV, Dh]; got {self.kv_k.shape}")
        if self.kv_len != len(self.prompt_tokens):
            raise ValueError(
                f"KV covers {self.kv_len} positions but the payload "
                f"names {len(self.prompt_tokens)} prompt tokens")
        if self.max_new_tokens < 1:
            raise ValueError("handoff with no decode budget left")
        if (self.kv_scale_k is None) != (self.kv_scale_v is None):
            raise ValueError("kv scale blobs must come as a pair")
        if self.kv_scale_k is not None:
            if self.kv_k.dtype != np.int8:
                raise ValueError(
                    "scale blobs ride only with int8 KV pages; got "
                    f"{self.kv_k.dtype}")
            want = self.kv_k.shape[:-1]
            if (self.kv_scale_k.shape != want
                    or self.kv_scale_v.shape != want):
                raise ValueError(
                    f"scale shape must be KV shape minus head_dim {want}; "
                    f"got {self.kv_scale_k.shape}/{self.kv_scale_v.shape}")

    # -- wire format -------------------------------------------------------

    def to_wire(self) -> bytes:
        """JSON metadata line + raw K bytes + raw V bytes (+ scale K/V bytes
        for an int8 pool: wire v2)."""
        meta = {
            "request_id": self.request_id,
            "prompt_tokens": list(self.prompt_tokens),
            "first_token": int(self.first_token),
            "max_new_tokens": int(self.max_new_tokens),
            "temperature": float(self.temperature),
            "top_k": int(self.top_k),
            "top_p": float(self.top_p),
            "stop_token": self.stop_token,
            "qos": self.qos,
        }
        return _encode(meta, self.kv_k, self.kv_v, self.kv_scale_k,
                       self.kv_scale_v)

    @classmethod
    def from_wire(cls, data: bytes) -> "HandoffPayload":
        meta, kv_k, kv_v, sk, sv = _decode(data, "handoff payload",
                                           "KV bytes")
        payload = cls(
            request_id=str(meta["request_id"]),
            prompt_tokens=[int(t) for t in meta["prompt_tokens"]],
            first_token=int(meta["first_token"]),
            max_new_tokens=int(meta["max_new_tokens"]),
            temperature=float(meta["temperature"]),
            top_k=int(meta["top_k"]),
            top_p=float(meta["top_p"]),
            stop_token=(None if meta["stop_token"] is None
                        else int(meta["stop_token"])),
            qos=str(meta["qos"]),
            kv_k=kv_k, kv_v=kv_v, kv_scale_k=sk, kv_scale_v=sv)
        payload.validate()
        return payload


def _encode(meta: dict, kv_k, kv_v, kv_sk, kv_sv) -> bytes:
    """``meta`` + dtype/shape tags as one JSON line, then the raw planes."""
    k = np.ascontiguousarray(kv_k)
    v = np.ascontiguousarray(kv_v)
    meta = {**meta, "dtype": _wire_name(k), "shape": list(k.shape)}
    blob = k.tobytes() + v.tobytes()
    if kv_sk is not None:
        sk = np.ascontiguousarray(kv_sk, np.float32)
        sv = np.ascontiguousarray(kv_sv, np.float32)
        meta["cache_dtype"] = "int8"
        meta["scale_dtype"] = str(sk.dtype)
        meta["scale_shape"] = list(sk.shape)
        blob += sk.tobytes() + sv.tobytes()
    return json.dumps(meta).encode() + b"\n" + blob


def _decode(data: bytes, what: str, unit: str):
    """(meta, k, v, scale_k, scale_v): read-only arrays over ``data``'s
    bytes; the scales are None for an untagged (v1) blob."""
    head, sep, raw = data.partition(b"\n")
    if not sep:
        raise ValueError(f"{what} missing metadata line")
    meta = json.loads(head)
    dtype = _np_dtype(meta["dtype"])
    shape = tuple(int(x) for x in meta["shape"])
    n = int(np.prod(shape)) * dtype.itemsize
    sk = sv = None
    sn = 0
    if meta.get("cache_dtype") is not None:
        sdtype = _np_dtype(meta["scale_dtype"])
        sshape = tuple(int(x) for x in meta["scale_shape"])
        sn = int(np.prod(sshape)) * sdtype.itemsize
    if len(raw) != 2 * n + 2 * sn:
        raise ValueError(
            f"{what} truncated: {len(raw)} {unit}, "
            f"expected {2 * n + 2 * sn}")
    kv_k = np.frombuffer(raw[:n], dtype=dtype).reshape(shape)
    kv_v = np.frombuffer(raw[n:2 * n], dtype=dtype).reshape(shape)
    if sn:
        sk = np.frombuffer(
            raw[2 * n:2 * n + sn], dtype=sdtype).reshape(sshape)
        sv = np.frombuffer(raw[2 * n + sn:], dtype=sdtype).reshape(sshape)
    return meta, kv_k, kv_v, sk, sv


def pages_to_wire(kv_k: np.ndarray, kv_v: np.ndarray, *,
                  kv_sk: Optional[np.ndarray] = None,
                  kv_sv: Optional[np.ndarray] = None) -> bytes:
    """The page-byte encoding the host KV tier stores (serve/kvtier.py):
    ``to_wire``'s layout without the request identity — a demoted page
    block is content, not a request. int8 pools pass the scale rows
    ``[L, pg, KV]`` and get the tagged v2 layout."""
    return _encode({}, kv_k, kv_v, kv_sk, kv_sv)


def pages_from_wire(data: bytes) -> tuple[
        np.ndarray, np.ndarray,
        Optional[np.ndarray], Optional[np.ndarray]]:
    """Decode ``pages_to_wire`` bytes into (k, v, scale_k, scale_v)
    zero-copy views: a promotion pays one copy, into its upload buffer.
    Scales are None for an untagged blob."""
    _, kv_k, kv_v, sk, sv = _decode(data, "page wire blob", "bytes")
    return kv_k, kv_v, sk, sv


def payload_from_export(req, kv_k: np.ndarray, kv_v: np.ndarray,
                        plen: int,
                        kv_sk: Optional[np.ndarray] = None,
                        kv_sv: Optional[np.ndarray] = None) -> HandoffPayload:
    """Build the payload at flush time from the fetched host arrays
    (trimmed to ``plen``); the decode budget is the original budget minus
    the first token the prefill side already emitted."""
    p = req.params
    payload = HandoffPayload(
        request_id=req.id,
        prompt_tokens=list(req.prompt_tokens),
        first_token=int(req.output_tokens[0]),
        max_new_tokens=int(p.max_new_tokens) - 1,
        temperature=float(p.temperature),
        top_k=int(p.top_k),
        top_p=float(p.top_p),
        stop_token=p.stop_token,
        qos=req.qos,
        kv_k=np.ascontiguousarray(kv_k[:, :plen]),
        kv_v=np.ascontiguousarray(kv_v[:, :plen]),
        kv_scale_k=(None if kv_sk is None
                    else np.ascontiguousarray(kv_sk[:, :plen])),
        kv_scale_v=(None if kv_sv is None
                    else np.ascontiguousarray(kv_sv[:, :plen])))
    payload.validate()
    return payload
