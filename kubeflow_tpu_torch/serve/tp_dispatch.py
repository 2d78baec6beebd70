"""One serving engine over the ranks of a ``model`` mesh axis: the leader
(rank 0 of the axis) runs the scheduler, and every device call that reads
weights or writes KV goes through one ``Dispatcher``, which sends the op
and its arguments to the followers; each runs the same call on its own
shards (``LLMEngine.follow``).

The JAX engine's mesh mode is one process over N chips (GSPMD partitions
each jitted dispatch); the port runs one process per card, so what GSPMD
does for it is done here: the call's name and the structure of its
arguments go to the followers over a gloo group (the header), and the
argument tensors' bytes in one broadcast over the axis's own group (NCCL
on the cards). Objects every rank keeps for itself — the params, the KV
planes, the sampling generator, the phase configs — travel as names
(``resident``) and resolve to the follower's own. A follower's generator
makes the same draws in the same order as the leader's, so a multi-step
decode feeds back the same tokens on every rank; a draw made on the
leader alone would put the ranks out of step, so the first-token sampling
is dispatched too. Both sides count the ops (``count``); equal counts
are the check that no call bypassed the dispatcher.

An idle leader pings the followers (``ping``), so the death of one fails
the leader's next ping instead of waiting for traffic; a dead leader
fails the followers' wait for the next header.
"""

from __future__ import annotations

import collections
import datetime
import time
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist

from kubeflow_tpu_torch.models.config import model_axis_of
from kubeflow_tpu_torch.models.layers import kv_head_owners

#: How long an idle follower waits for the next header: as long as the
#: leader may sit idle (its pings arrive every ``PING_S``).
IDLE_TIMEOUT = datetime.timedelta(days=365)
#: An idle leader's ping interval, seconds.
PING_S = 1.0


class Dispatcher:
    """The leader's and followers' end of a tensor-parallel engine's op
    stream over ``tp`` (a ``collectives.ModelAxis``). ``ops`` maps op
    name → function; ``resident`` maps name → an object every rank keeps
    (each rank passes its own)."""

    def __init__(self, tp, device: torch.device, ops: dict[str, Callable],
                 resident: dict[str, Any]):
        self.tp = tp
        self.device = device
        self.leader = tp.rank == 0
        self.ops = ops
        self.resident = resident
        self._names = {id(v): k for k, v in resident.items()}
        ranks = dist.get_process_group_ranks(tp.group)
        self._src = ranks[0]
        # Every rank of the world makes the header group, in one order.
        self._ctrl = dist.new_group(ranks, backend="gloo",
                                    timeout=IDLE_TIMEOUT)
        #: Ops dispatched (leader) or run (follower), in all and by name.
        self.count = 0
        self.by_op: collections.Counter = collections.Counter()
        #: The leader's host seconds spent sending (header and bytes).
        self.send_s = 0.0
        #: Argument bytes each follower received, by op name.
        self.bytes_by_op: collections.Counter = collections.Counter()
        self._last = time.monotonic()
        self.closed = False

    # -- leader ----------------------------------------------------------------

    def call(self, fn: Callable, *args, **kwargs):
        """Send ``fn``'s call to the followers, then run it here."""
        if self.ops.get(fn.__name__) is not fn:
            raise KeyError(f"{fn.__name__} is not a dispatched op")
        t0 = time.perf_counter()
        tensors: list[torch.Tensor] = []
        spec = self._pack((args, kwargs), tensors)
        self._send((fn.__name__, spec, [(tuple(t.shape), t.dtype)
                                        for t in tensors]))
        if tensors:
            self.bytes_by_op[fn.__name__] += self._send_bytes(tensors)
        self.count += 1
        self.by_op[fn.__name__] += 1
        self.send_s += time.perf_counter() - t0
        self._last = time.monotonic()
        return fn(*args, **kwargs)

    def ping(self) -> None:
        """An empty header, when the leader has sent nothing for
        ``PING_S``: a follower that died fails it."""
        if time.monotonic() - self._last >= PING_S:
            self._send(("", None, None))
            self._last = time.monotonic()

    def close(self) -> None:
        """Release the followers from their loop (once)."""
        if not self.closed:
            self.closed = True
            self._send((None, None, None))

    def _send(self, header) -> None:
        dist.broadcast_object_list([header], src=self._src, group=self._ctrl)

    def _pack(self, x, tensors: list):
        name = self._names.get(id(x))
        if name is not None:
            return ("ref", name)
        if isinstance(x, torch.Tensor):
            tensors.append(x)
            return ("tensor", len(tensors) - 1)
        if isinstance(x, dict):
            return ("dict", [(k, self._pack(v, tensors))
                             for k, v in x.items()])
        if isinstance(x, (list, tuple)):
            return (type(x).__name__, [self._pack(v, tensors) for v in x])
        if x is None or isinstance(x, (bool, int, float, str)):
            return ("value", x)
        raise TypeError(f"a dispatched argument of type {type(x).__name__}"
                        " is neither a tensor, a plain value nor resident")

    def _send_bytes(self, tensors: list) -> int:
        """The tensors' bytes, packed into one buffer, in one broadcast;
        returns their number."""
        buf = torch.cat([_raw(t) for t in tensors])
        dist.broadcast(buf, src=self._src, group=self.tp.group)
        return buf.numel()

    # -- follower --------------------------------------------------------------

    def follow(self) -> int:
        """Run the leader's ops until it closes; returns the count."""
        with torch.no_grad():
            while True:
                got = [None]
                dist.broadcast_object_list(got, src=self._src,
                                           group=self._ctrl)
                name, spec, metas = got[0]
                if name is None:
                    self.closed = True
                    return self.count
                if not name:
                    continue                            # a ping
                tensors = self._recv_bytes(metas)
                args, kwargs = self._unpack(spec, tensors)
                self.count += 1
                self.by_op[name] += 1
                self.ops[name](*args, **kwargs)

    def _recv_bytes(self, metas: list) -> list[torch.Tensor]:
        """The leader's ``_send_bytes``: tensors of ``metas`` (shape,
        dtype) unpacked from one broadcast buffer."""
        if not metas:
            return []
        buf = torch.empty(sum(_nbytes(m) for m in metas), dtype=torch.uint8,
                          device=self.device)
        dist.broadcast(buf, src=self._src, group=self.tp.group)
        return _split_raw(buf, metas)

    def _unpack(self, spec, tensors: list):
        kind, v = spec
        if kind == "ref":
            return self.resident[v]
        if kind == "tensor":
            return tensors[v]
        if kind == "dict":
            return {k: self._unpack(s, tensors) for k, s in v}
        if kind == "list":
            return [self._unpack(s, tensors) for s in v]
        if kind == "tuple":
            return tuple(self._unpack(s, tensors) for s in v)
        return v


def gather_kv_heads(cfg, planes: list[torch.Tensor], axis: int
                    ) -> Optional[list[torch.Tensor]]:
    """``planes`` (this rank's kv heads on dim ``axis``) with the whole
    model's kv heads, on the leader of ``cfg``'s model axis: every rank's
    bytes (padded to the largest rank's) in one ``gather`` over the axis's
    group (NCCL on the cards, gloo on the CPU), each head taken from its
    first owner (``layers.kv_head_owners``), so a kv head held on several
    ranks, or twice on one, is taken once. None on the other ranks;
    ``planes`` themselves without an axis. Every rank of the axis calls it
    at the same point of the op stream: inside a dispatched op."""
    tp = model_axis_of(cfg)
    if tp is None:
        return planes
    owners = kv_head_owners(cfg)

    def metas_of(heads: tuple) -> list:
        return [(tuple(len(heads) if d == axis else n
                       for d, n in enumerate(t.shape)), t.dtype)
                for t in planes]

    size = max(sum(_nbytes(m) for m in metas_of(h)) for h in owners)
    buf = torch.cat([_raw(t) for t in planes])
    if buf.numel() < size:
        buf = torch.cat([buf, buf.new_zeros(size - buf.numel())])
    parts = ([torch.empty_like(buf) for _ in range(tp.size)]
             if tp.rank == 0 else None)
    dist.gather(buf, parts, dst=dist.get_process_group_ranks(tp.group)[0],
                group=tp.group)
    if parts is None:
        return None
    got = [_split_raw(p, metas_of(h)) for p, h in zip(parts, owners)]
    pick = {}
    for r, heads in enumerate(owners):
        for i, kv in enumerate(heads):
            pick.setdefault(kv, (r, i))
    return [torch.cat([got[r][j].narrow(axis, i, 1)
                       for r, i in (pick[kv] for kv in sorted(pick))],
                      dim=axis)
            for j in range(len(planes))]


def _nbytes(meta) -> int:
    shape, dtype = meta
    n = 1
    for d in shape:
        n *= d
    return n * (1 if dtype == torch.bool else dtype.itemsize)


def _split_raw(buf: torch.Tensor, metas: list) -> list[torch.Tensor]:
    """Tensors of ``metas`` (shape, dtype) from their packed bytes."""
    out, at = [], 0
    for shape, dt in metas:
        o = torch.empty(shape, dtype=dt, device=buf.device)
        n = _nbytes((shape, dt))
        part = buf[at:at + n]
        if dt == torch.bool:
            o.copy_(part.bool().reshape(shape))
        else:
            o.reshape(-1).view(torch.uint8).copy_(part)
        out.append(o)
        at += n
    return out


def _raw(t: torch.Tensor) -> torch.Tensor:
    """``t``'s bytes as a flat uint8 tensor (a bool as 0/1 bytes)."""
    t = t.contiguous().reshape(-1)
    return t.to(torch.uint8) if t.dtype == torch.bool else t.view(torch.uint8)
