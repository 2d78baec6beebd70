"""Checkpoints: the port's own format with per-step integrity manifests,
asynchronous saves, verified restore, quarantine and tiered resume (port
of ``kubeflow_tpu/train/checkpoint.py``, which saves through orbax with
asynchronous checkpointing on).

Layout of a checkpoint directory::

    <dir>/<step>/meta.json            every tensor's file, dtype and shape
                                      by tree path, and every non-tensor
                                      leaf (counts, the step)
    <dir>/<step>/<path>.bin           one tensor per file: its raw bytes,
                                      C order, native byte order
    <dir>/manifests/<step>.json       {"step", "files": {rel: {size, sha256}}}
    <dir>/quarantine/<step>[.n]       steps that failed verification

A save is asynchronous, with orbax's semantics. ``save()`` first waits
for the save in flight, then copies every tensor leaf into host buffers
(page-locked for a card's tensors, kept from save to save, one
synchronisation for all) and returns: the caller may then change the
state in place, as the optimizer does. One writer thread writes the files
under a temporary name, renames the directory into place, writes the
manifest from the bytes on disk and drops steps past ``max_to_keep``;
files are written and hashed on up to 8 threads. ``latest_step()``
includes the step in flight, ``latest_committed_step()`` only steps that
were renamed and have a manifest. ``wait()`` joins the save in flight and
raises its error, once; ``save()`` raises it too, before it starts a new
save, and ``close()`` waits. ``restore()`` waits for the save in flight
before it picks a step. Host memory holds one snapshot of the state,
also where two managers save it: a trainer's interval and emergency
tiers share one ``HostBuffers``.

The guarantees are the reference's. A crash mid-save leaves no step
directory, only a temporary one that the next manager removes. The
manifest is written after the rename, from the bytes on disk. Files are
not fsynced: bytes a power loss tore after the rename fail the manifest
check. ``restore`` checks the manifest before any tensor is loaded and
raises ``CheckpointCorruptionError`` on a missing or extra file, a
checksum mismatch, or a tensor file whose size is not its meta's.
``resume_from_tiers`` walks the steps of every tier newest first (the
emergency tier before the interval tier on equal steps), quarantines each
step that fails and counts the fallbacks. Orbax checkpoints of the JAX
package are not read.

Sharded saves (a ``ShardLayout`` of a world above one process): each
rank snapshots the blocks it writes (one writer per block: the rank whose
coordinates are 0 on every axis the leaf is not split over) and writes
them on its own writer thread into the step's shared temporary directory
as ``<path>.r<rank>.bin`` (a replicated leaf whole, as ``<path>.bin``),
then its ``meta.r<rank>.json``: each block's global slice and its files'
sizes and hashes. The coordinator's writer waits for every rank's
``meta.r*.json`` (the barrier; ``_COMMIT_TIMEOUT_S`` at most), merges
them into ``meta.json``, renames the directory into place and writes the
manifest; the other ranks' writers wait for that manifest. Only the
coordinator removes temporary directories, drops old steps, writes
manifests and quarantines. ``restore(layout=...)`` reads the slices a
rank needs from whatever blocks cover them, so a step saved at one world
size restores bit for bit at any other, including one process.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import hashlib
import json
import logging
import os
import shutil
import threading
import time
from typing import Any, Optional

import torch

from kubeflow_tpu_torch.parallel.sharding import local_slices
from kubeflow_tpu_torch.train import tree as T

logger = logging.getLogger("kubeflow_tpu_torch.train.checkpoint")

_MANIFEST_DIR = "manifests"
_QUARANTINE_DIR = "quarantine"
_META = "meta.json"
_TMP = ".tmp-"
#: Threads that write and hash a step's files (file I/O and SHA-256
#: release the interpreter lock).
_THREADS = min(8, os.cpu_count() or 1)
#: Seconds a sharded save's writer waits for the other ranks' blocks (the
#: coordinator) or for the coordinator's commit (every other rank).
_COMMIT_TIMEOUT_S = 600.0


class CheckpointCorruptionError(RuntimeError):
    """A checkpoint step failed manifest verification: the bytes on disk are
    not the bytes saved."""


def _sha256(path: str, chunk: int = 1 << 24) -> str:
    h = hashlib.sha256()
    buf = memoryview(bytearray(chunk))
    with open(path, "rb") as f:
        while n := f.readinto(buf):
            h.update(buf[:n])
    return h.hexdigest()


def _file_entry(path: str) -> dict:
    """A manifest entry: the file's size and the SHA-256 of its bytes as
    read back from the filesystem."""
    return {"size": os.path.getsize(path), "sha256": _sha256(path)}


def _bytes_of(t: torch.Tensor) -> memoryview:
    """A contiguous CPU tensor's bytes, without a copy."""
    return memoryview(t.reshape(-1).view(torch.uint8).numpy())


def _dtype(name: str) -> torch.dtype:
    dt = getattr(torch, name.removeprefix("torch."), None)
    if not isinstance(dt, torch.dtype):
        raise CheckpointCorruptionError(f"unknown dtype {name!r} in meta")
    return dt


def _map(fn, items) -> list:
    """``fn`` over ``items`` on ``_THREADS`` threads, in order."""
    items = list(items)
    if _THREADS <= 1 or len(items) <= 1:
        return [fn(it) for it in items]
    with concurrent.futures.ThreadPoolExecutor(_THREADS) as pool:
        return list(pool.map(fn, items))


class HostBuffers:
    """The host buffers of one snapshot, by tree path, for the managers
    that save one state: reused while a leaf keeps its shape, dtype and
    pinning. ``owner`` is the manager whose last save filled them; its
    writer reads them until that save is committed, so another manager's
    snapshot waits for it first."""

    def __init__(self):
        self.buffers: dict[str, torch.Tensor] = {}
        self.owner: Optional["CheckpointManager"] = None


@dataclasses.dataclass(frozen=True)
class ShardLayout:
    """Which block of each tensor leaf a process holds: the mesh degrees
    (``sizes``), its coordinates, each split leaf's spec by flattened
    state path (a path not listed is whole on every rank), and its rank
    among ``world`` processes."""

    sizes: dict
    coords: dict
    specs: dict
    rank: int = 0
    world: int = 1

    def _spec(self, path: str) -> tuple:
        return tuple(self.specs.get(path, ()))

    def _axes(self, path: str) -> set:
        out = set()
        for e in self._spec(path):
            out.update((e,) if isinstance(e, str) else (e or ()))
        return out

    def writes(self, path: str) -> bool:
        """Whether this rank writes its block of ``path``: its coordinate
        is 0 on every axis the leaf is not split over."""
        used = self._axes(path)
        return all(c == 0 for a, c in self.coords.items() if a not in used)

    def block(self, path: str, shape) -> tuple[slice, ...]:
        """This rank's block of a leaf of global ``shape``."""
        return local_slices(tuple(shape), self._spec(path), self.sizes,
                            self.coords)

    def global_shape(self, path: str, local_shape) -> list[int]:
        spec = self._spec(path) + (None,) * len(local_shape)
        out = []
        for n, e in zip(local_shape, spec):
            axes = (e,) if isinstance(e, str) else tuple(e or ())
            deg = 1
            for a in axes:
                deg *= int(self.sizes.get(a, 1))
            out.append(int(n) * deg)
        return out


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 3,
                 host: Optional[HostBuffers] = None,
                 layout: Optional[ShardLayout] = None):
        """``host``: the snapshot buffers to share with other managers of
        the same state (default: this manager's own). ``layout``: this
        process's blocks of a sharded state (a world above one process
        saves sharded)."""
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self._max_to_keep = max_to_keep
        self._host = host if host is not None else HostBuffers()
        self._layout = (layout if layout is not None and layout.world > 1
                        else None)
        self._writer: Optional[threading.Thread] = None
        self._in_flight: Optional[int] = None
        self._error: Optional[BaseException] = None
        #: The last save's times (``time.perf_counter`` seconds):
        #: ``called``, ``returned`` (snapshot taken), ``written`` (every
        #: file written and hashed), ``waited`` (a caller began to wait
        #: for it in flight) and ``committed``.
        self.last_save: dict = {}
        # Temporary directories of saves a crash interrupted.
        if self.is_coordinator:
            for d in os.listdir(self.directory):
                if _TMP in d:
                    shutil.rmtree(os.path.join(self.directory, d),
                                  ignore_errors=True)

    @property
    def is_coordinator(self) -> bool:
        return self._layout is None or self._layout.rank == 0

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(step))

    def save(self, step: int, state: Any, *, force: bool = False) -> bool:
        """Start saving ``state`` (nested dicts of tensors and plain values)
        as ``step``; returns once the state may change. Returns False,
        saving nothing, when the step exists and ``force`` is not set.
        Waits for the save in flight first and raises its error, if it
        failed, without starting this one."""
        called = time.perf_counter()
        self.wait()
        final = self._step_dir(step)
        if os.path.exists(final) and not force:
            return False
        flat = T.flatten(state)
        tensors = {p: t for p, t in flat.items()
                   if isinstance(t, torch.Tensor)}
        values = json.loads(json.dumps(
            {p: v for p, v in flat.items() if p not in tensors}))
        if self._layout is not None:
            tensors = {p: t for p, t in tensors.items()
                       if self._layout.writes(p)}
        host = self._snapshot(tensors)
        self._in_flight = step
        self.last_save = {"step": step, "called": called,
                          "returned": time.perf_counter()}
        self._writer = threading.Thread(
            target=self._write if self._layout is None
            else self._write_sharded, args=(step, host, values),
            name=f"ckpt-writer-{step}", daemon=True)
        self._writer.start()
        return True

    def _snapshot(self, tensors: dict) -> dict:
        """Every tensor leaf copied to host memory: a card's leaves into
        page-locked buffers, asynchronously, then one synchronisation per
        device; the buffers are kept for the next save, this manager's or
        another's that shares them (whose save in flight lands first)."""
        pool = self._host
        if pool.owner is not None and pool.owner is not self:
            pool.owner._join()      # its writer reads these buffers
        keep = {}
        devices = set()
        for path, t in tensors.items():
            buf = pool.buffers.get(path)
            pinned = t.device.type == "cuda"
            if (buf is None or buf.shape != t.shape or buf.dtype != t.dtype
                    or buf.is_pinned() != pinned):
                buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=pinned)
            buf.copy_(t.detach(), non_blocking=pinned)
            if pinned:
                devices.add(t.device)
            keep[path] = buf
        for dev in devices:
            torch.cuda.current_stream(dev).synchronize()
        pool.buffers, pool.owner = keep, self
        return keep

    def _write(self, step: int, host: dict, values: dict) -> None:
        tmp = os.path.join(self.directory, f"{step}{_TMP}{os.getpid()}")
        final = self._step_dir(step)
        try:
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            tensors = {p: {"file": p.replace("/", ".") + ".bin",
                           "dtype": str(t.dtype).removeprefix("torch."),
                           "shape": list(t.shape)}
                       for p, t in host.items()}

            def write(rel: str, data) -> tuple:
                # Each file is read back and hashed as soon as it is
                # written: the threads overlap writing and hashing.
                with open(os.path.join(tmp, rel), "wb") as f:
                    f.write(data)
                return rel, _file_entry(os.path.join(tmp, rel))

            meta = json.dumps({"step": step, "tensors": tensors,
                               "values": values}).encode()
            files = dict(_map(lambda item: write(*item), [
                (tensors[p]["file"], _bytes_of(t)) for p, t in host.items()
            ] + [(_META, meta)]))
            self.last_save["written"] = time.perf_counter()
            self._drop_manifest(step)   # a forced save's old one
            if os.path.exists(final):
                shutil.rmtree(final)
            os.replace(tmp, final)
            self._write_manifest(step, files)
            self._gc()
            self.last_save["committed"] = time.perf_counter()
        except BaseException as exc:
            # Kept for wait() and the next save(), which raise it.
            shutil.rmtree(tmp, ignore_errors=True)
            self._error = exc
            if not isinstance(exc, Exception):
                raise

    def _write_sharded(self, step: int, host: dict, values: dict) -> None:
        lay = self._layout
        tmp = os.path.join(self.directory, f"{step}{_TMP}shared")
        final = self._step_dir(step)
        marker = f"meta.r{lay.rank}.json"
        try:
            os.makedirs(tmp, exist_ok=True)
            entries, data = {}, []
            for p, t in host.items():
                shape = lay.global_shape(p, t.shape)
                block = lay.block(p, shape)
                whole = list(t.shape) == shape
                name = p.replace("/", ".") + (
                    ".bin" if whole else f".r{lay.rank}.bin")
                entries[p] = {
                    "dtype": str(t.dtype).removeprefix("torch."),
                    "shape": shape,
                    "parts": [{"file": name, "block": [
                        [b.start, b.stop] for b in block]}]}
                data.append((name, _bytes_of(t)))

            def write(rel: str, payload) -> tuple:
                with open(os.path.join(tmp, rel), "wb") as f:
                    f.write(payload)
                return rel, _file_entry(os.path.join(tmp, rel))

            files = dict(_map(lambda item: write(*item), data))
            part = os.path.join(tmp, f"{marker}.part")
            with open(part, "w") as f:
                json.dump({"rank": lay.rank, "tensors": entries,
                           "files": files}, f)
            os.replace(part, os.path.join(tmp, marker))
            self.last_save["written"] = time.perf_counter()
            if lay.rank == 0:
                self._commit_sharded(step, tmp, final, values)
            else:
                self._await(lambda: os.path.exists(
                    self._manifest_path(step)), f"step {step}'s commit")
            self.last_save["committed"] = time.perf_counter()
        except BaseException as exc:
            self._error = exc
            if not isinstance(exc, Exception):
                raise

    def _await(self, ready, what: str) -> None:
        deadline = time.monotonic() + _COMMIT_TIMEOUT_S
        while not ready():
            if time.monotonic() > deadline:
                raise TimeoutError(f"{what}: not there after "
                                   f"{_COMMIT_TIMEOUT_S:g} s")
            time.sleep(0.02)

    def _commit_sharded(self, step: int, tmp: str, final: str,
                        values: dict) -> None:
        """The coordinator's half of a sharded save: wait for every rank's
        blocks, merge their metas, rename, write the manifest."""
        world = self._layout.world
        markers = [f"meta.r{r}.json" for r in range(world)]
        self._await(lambda: all(os.path.exists(os.path.join(tmp, m))
                                for m in markers),
                    f"step {step}'s blocks from {world} ranks")
        tensors: dict = {}
        files: dict = {}
        for m in markers:
            with open(os.path.join(tmp, m)) as f:
                got = json.load(f)
            for p, e in got["tensors"].items():
                if p in tensors:
                    tensors[p]["parts"].extend(e["parts"])
                else:
                    tensors[p] = e
            files.update(got["files"])
            files[m] = _file_entry(os.path.join(tmp, m))
        with open(os.path.join(tmp, _META), "w") as f:
            json.dump({"step": step, "tensors": tensors, "values": values,
                       "world": world}, f)
        files[_META] = _file_entry(os.path.join(tmp, _META))
        self._drop_manifest(step)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        self._write_manifest(step, files)
        self._gc()

    def _join(self) -> None:
        """Wait for the save in flight, keeping its error for ``wait``."""
        if self._writer is not None:
            if self._writer.is_alive():
                self.last_save.setdefault("waited", time.perf_counter())
            self._writer.join()
            self._writer = None
        self._in_flight = None

    def wait(self) -> None:
        """Join the save in flight; raise its error if it failed (once)."""
        self._join()
        err, self._error = self._error, None
        if err is not None:
            raise err

    def close(self) -> None:
        """Wait for the save in flight, write any missing manifest and
        free the host buffers if this manager's save filled them last."""
        try:
            self.wait()
        finally:
            if self._host.owner is self:
                self._host.buffers, self._host.owner = {}, None
            if self.is_coordinator:
                self.flush_manifests()

    def _gc(self) -> None:
        if not self.is_coordinator:
            return
        steps = self.steps_on_disk()
        for step in steps[:max(len(steps) - self._max_to_keep, 0)]:
            shutil.rmtree(self._step_dir(step), ignore_errors=True)
            self._drop_manifest(step)

    def restore(self, step: Optional[int] = None, *, device="cpu",
                verify: bool = True,
                subtree: Optional[str] = None,
                leaf_fn=None,
                layout: Optional[ShardLayout] = None) -> Optional[Any]:
        """The state saved as ``step`` (default: the newest), tensors on
        ``device``; None when nothing is saved. The manifest is verified
        first, before any tensor is loaded. ``subtree`` (e.g. ``"params"``)
        loads only that key's leaves and returns that subtree; the manifest
        check then covers the files it reads (and ``meta.json``).
        ``leaf_fn(path, tensor)`` replaces each tensor as it is loaded
        (path relative to ``subtree``), so only one loaded leaf is alive
        beside the transformed ones. ``layout``: load this process's block
        of each leaf (default: whole leaves), from a step saved at any
        world size."""
        self._join()
        target = step if step is not None else self.latest_step()
        if target is None:
            return None
        root = self._step_dir(target)
        head = f"{subtree}/" if subtree else ""

        def wanted(entries: dict) -> dict:
            return {p[len(head):]: v for p, v in entries.items()
                    if p.startswith(head)}

        if verify and not subtree:
            self.verify_step(target)
        with open(os.path.join(root, _META)) as f:
            meta = json.load(f)
        if verify and subtree:
            self.verify_step(target, only={_META, *(
                f for e in wanted(meta["tensors"]).values()
                for f in _files_of(e))})
        flat = wanted(meta["values"])
        for path, entry in wanted(meta["tensors"]).items():
            block = (layout.block(head + path, entry["shape"])
                     if layout is not None else None)
            t = _read_block(root, entry, block)
            t = t.to(device)
            flat[path] = t if leaf_fn is None else leaf_fn(path, t)
        if subtree and not flat:
            raise KeyError(f"step {target} holds no {subtree!r} subtree")
        return T.unflatten(flat)

    def latest_step(self) -> Optional[int]:
        """Newest step the manager knows of: the save in flight counts,
        before its bytes are on disk."""
        steps = self.steps_on_disk()
        if self._in_flight is not None:
            steps.append(self._in_flight)
        return max(steps) if steps else None

    def latest_committed_step(self) -> Optional[int]:
        """Newest step renamed into place with its manifest written: what a
        restart could restore."""
        steps = [s for s in self.steps_on_disk()
                 if os.path.exists(self._manifest_path(s))]
        return steps[-1] if steps else None

    def steps_on_disk(self) -> list[int]:
        """Step directories present, oldest first (a quarantined step is
        not among them)."""
        try:
            return sorted(int(d) for d in os.listdir(self.directory)
                          if d.isdigit())
        except OSError:
            return []

    # -- integrity manifests ---------------------------------------------------

    def _manifest_path(self, step: int) -> str:
        return os.path.join(self.directory, _MANIFEST_DIR, f"{step}.json")

    def _drop_manifest(self, step: int) -> None:
        try:
            os.remove(self._manifest_path(step))
        except OSError:
            pass

    def _step_files(self, step: int,
                    only: Optional[set] = None) -> dict[str, dict]:
        """Size and SHA-256 of the step's files, hashed on ``_THREADS``
        threads."""
        root = self._step_dir(step)
        rels = []
        for base, _, files in os.walk(root):
            for fn in files:
                rel = os.path.relpath(os.path.join(base, fn), root)
                if only is None or rel in only:
                    rels.append(rel)

        return dict(zip(rels, _map(lambda rel: _file_entry(
            os.path.join(root, rel)), rels)))

    def _write_manifest(self, step: int, files: dict) -> None:
        mpath = self._manifest_path(step)
        os.makedirs(os.path.dirname(mpath), exist_ok=True)
        tmp = f"{mpath}.tmp"
        with open(tmp, "w") as f:
            json.dump({"step": step, "files": files}, f)
        os.replace(tmp, mpath)

    def flush_manifests(self) -> None:
        """Write a manifest for every step on disk that lacks one (a step
        a crash left between its rename and its manifest)."""
        for step in self.steps_on_disk():
            if not os.path.exists(self._manifest_path(step)):
                self._write_manifest(step, self._step_files(step))

    def verify_step(self, step: int, only: Optional[set] = None) -> bool:
        """Check the step's bytes against its manifest. True = verified,
        False = no manifest to verify against. Raises
        ``CheckpointCorruptionError`` on any mismatch. ``only`` (relative
        file names) checks just those files: each must be in the manifest,
        on disk, and match."""
        try:
            with open(self._manifest_path(step)) as f:
                manifest = json.load(f)
        except FileNotFoundError:
            return False
        except ValueError as exc:
            raise CheckpointCorruptionError(
                f"step {step}: manifest unreadable: {exc}") from exc
        expect: dict = manifest.get("files", {})
        if only is not None:
            unknown = sorted(only - set(expect))
            if unknown:
                raise CheckpointCorruptionError(
                    f"step {step}: {unknown[:3]} not in its manifest")
            expect = {rel: expect[rel] for rel in only}
        actual = self._step_files(step, only)
        if set(expect) != set(actual):
            missing = sorted(set(expect) - set(actual))[:3]
            extra = sorted(set(actual) - set(expect))[:3]
            raise CheckpointCorruptionError(
                f"step {step}: file set mismatch (missing={missing}, "
                f"extra={extra})")
        for rel, meta in expect.items():
            got = actual[rel]
            if got["size"] != meta["size"] or got["sha256"] != meta["sha256"]:
                raise CheckpointCorruptionError(
                    f"step {step}: checksum mismatch in {rel}")
        return True

    def quarantine_step(self, step: int) -> Optional[str]:
        """Move a bad step out of the candidate set into ``quarantine/``
        (kept for post-mortem). Returns its new path, or None if it is
        already gone."""
        qdir = os.path.join(self.directory, _QUARANTINE_DIR)
        os.makedirs(qdir, exist_ok=True)
        dst = os.path.join(qdir, str(step))
        i = 0
        while os.path.exists(dst):
            i += 1
            dst = os.path.join(qdir, f"{step}.{i}")
        try:
            os.rename(self._step_dir(step), dst)
        except OSError:
            return None
        self._drop_manifest(step)
        logger.warning("quarantined corrupt checkpoint step %d -> %s",
                       step, dst)
        return dst


def _read_tensor(path: str, entry: dict) -> torch.Tensor:
    """A tensor file of the layout above, on the host."""
    t = torch.empty(entry["shape"], dtype=_dtype(entry["dtype"]))
    view = _bytes_of(t)
    with open(path, "rb") as f:
        got = f.readinto(view)
        extra = f.read(1)
    if got != len(view) or extra:
        raise CheckpointCorruptionError(
            f"{path}: {got}{'+' if extra else ''} bytes, meta says "
            f"{len(view)}")
    return t


def _read_slices(path: str, entry: dict, block: tuple) -> torch.Tensor:
    """The slices ``block`` of a tensor file, reading only their bytes
    (through a memory map of the file, viewed as same-width integers)."""
    import numpy as np

    dt = _dtype(entry["dtype"])
    width = torch.empty((), dtype=dt).element_size()
    size = os.path.getsize(path)
    n = 1
    for d in entry["shape"]:
        n *= d
    if size != n * width:
        raise CheckpointCorruptionError(
            f"{path}: {size} bytes, meta says {n * width}")
    raw = np.memmap(path, dtype=f"<i{width}" if width > 1 else np.uint8,
                    mode="r", shape=tuple(entry["shape"]))
    return torch.from_numpy(np.ascontiguousarray(raw[block])).view(dt)


def _files_of(entry: dict) -> list[str]:
    if "parts" in entry:
        return [p["file"] for p in entry["parts"]]
    return [entry["file"]]


def _read_block(root: str, entry: dict,
                block: Optional[tuple]) -> torch.Tensor:
    """The slices ``block`` (default: all) of a tensor saved whole or in
    blocks: each saved block that overlaps is read and its overlap
    copied in."""
    shape = entry["shape"]
    if "parts" not in entry:
        if block is None:
            return _read_tensor(os.path.join(root, entry["file"]), entry)
        return _read_slices(os.path.join(root, entry["file"]), entry, block)
    want = block or tuple(slice(0, n) for n in shape)
    out = torch.empty([w.stop - w.start for w in want],
                      dtype=_dtype(entry["dtype"]))
    covered = 0
    for part in entry["parts"]:
        have = [slice(a, b) for a, b in part["block"]]
        lo = [max(w.start, h.start) for w, h in zip(want, have)]
        hi = [min(w.stop, h.stop) for w, h in zip(want, have)]
        if any(a >= b for a, b in zip(lo, hi)):
            continue
        t = _read_tensor(os.path.join(root, part["file"]), {
            "dtype": entry["dtype"],
            "shape": [h.stop - h.start for h in have]})
        src = tuple(slice(a - h.start, b - h.start)
                    for a, b, h in zip(lo, hi, have))
        dst = tuple(slice(a - w.start, b - w.start)
                    for a, b, w in zip(lo, hi, want))
        out[dst] = t[src]
        n = 1
        for a, b in zip(lo, hi):
            n *= b - a
        covered += n
    if covered != out.numel():
        raise CheckpointCorruptionError(
            f"{root}: the saved blocks cover {covered} of the "
            f"{out.numel()} elements asked for")
    return out


def resume_from_tiers(managers: list[tuple[str, CheckpointManager]], *,
                      device="cpu", layout: Optional[ShardLayout] = None,
                      quarantine: bool = True):
    """Restore the newest valid step across checkpoint tiers.

    ``managers`` is ``[(tier_name, manager), ...]`` in preference order for
    equal steps (the trainer passes the emergency tier first). Candidates
    are walked newest first; a step that fails verification or whose
    restore raises is quarantined (by the coordinator: ``quarantine``)
    and the walk falls back to the next older one; each tier's save in
    flight is waited for first. ``layout``: this rank's blocks. Returns
    ``(state, step, tier_name, fallbacks)`` or None when no tier holds a
    restorable step."""
    candidates = []
    for order, (tier, mgr) in enumerate(managers):
        mgr._join()     # a save in flight lands (or fails) before the walk
        for step in mgr.steps_on_disk():
            candidates.append((step, -order, tier, mgr))
    candidates.sort(key=lambda c: (c[0], c[1]), reverse=True)
    fallbacks = 0
    for step, _, tier, mgr in candidates:
        try:
            state = mgr.restore(step, device=device, layout=layout)
        except Exception as exc:    # corruption, or a torn or unreadable save
            fallbacks += 1
            logger.error("restore fallback: step %d (%s tier) invalid: %s",
                         step, tier, exc)
            if quarantine:
                mgr.quarantine_step(step)
            continue
        if state is None:
            continue
        return state, step, tier, fallbacks
    return None
