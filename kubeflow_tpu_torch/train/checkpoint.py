"""Checkpoints: a torch format with per-step integrity manifests, verified
restore, quarantine and tiered resume (port of
``kubeflow_tpu/train/checkpoint.py``, which saves through orbax).

Layout of a checkpoint directory::

    <dir>/<step>/meta.json            tree paths of the tensors, and every
                                      non-tensor leaf (counts, the step)
    <dir>/<step>/<path>.pt            one tensor per file (torch.save)
    <dir>/manifests/<step>.json       {"step", "files": {rel: {size, sha256}}}
    <dir>/quarantine/<step>[.n]       steps that failed verification

The guarantees are the reference's. A step is written under a temporary
name and renamed into place only when every file is written, so a crash
mid-save leaves no step directory, only a temporary one that the next
manager removes. The manifest is written after the rename, from the bytes
on disk. Files are not fsynced: bytes a power loss tore after the rename
fail the manifest check. ``restore`` checks the manifest before any tensor is
loaded and raises ``CheckpointCorruptionError`` on a missing or extra file
or a checksum mismatch. ``resume_from_tiers`` walks the steps of every
tier newest first (the emergency tier before the interval tier on equal
steps), quarantines each step that fails and counts the fallbacks.

One tensor per file keeps the host memory a save needs to its largest
tensor. Saving is synchronous in this version, so ``wait()`` has nothing
to wait for. Orbax checkpoints of the JAX package are not read.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import shutil
from typing import Any, Optional

import torch

from kubeflow_tpu_torch.train import tree as T

logger = logging.getLogger("kubeflow_tpu_torch.train.checkpoint")

_MANIFEST_DIR = "manifests"
_QUARANTINE_DIR = "quarantine"
_META = "meta.json"
_TMP = ".tmp-"


class CheckpointCorruptionError(RuntimeError):
    """A checkpoint step failed manifest verification: the bytes on disk are
    not the bytes saved."""


def _sha256(path: str, chunk: int = 1 << 24) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            b = f.read(chunk)
            if not b:
                return h.hexdigest()
            h.update(b)


def _write(path: str, write) -> None:
    with open(path, "wb") as f:
        write(f)


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self._max_to_keep = max_to_keep
        # Temporary directories of saves a crash interrupted.
        for d in os.listdir(self.directory):
            if _TMP in d:
                shutil.rmtree(os.path.join(self.directory, d),
                              ignore_errors=True)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(step))

    def save(self, step: int, state: Any, *, force: bool = False) -> bool:
        """Write ``state`` (nested dicts of tensors and plain values) as
        ``step``. Returns False, saving nothing, when the step exists and
        ``force`` is not set; raises on a storage failure."""
        final = self._step_dir(step)
        if os.path.exists(final) and not force:
            return False
        tmp = os.path.join(self.directory, f"{step}{_TMP}{os.getpid()}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        try:
            tensors, values = {}, {}
            for path, leaf in T.flatten(state).items():
                if isinstance(leaf, torch.Tensor):
                    rel = path.replace("/", ".") + ".pt"
                    host = leaf.detach().to("cpu")
                    _write(os.path.join(tmp, rel),
                           lambda f: torch.save(host, f))
                    tensors[path] = rel
                else:
                    values[path] = leaf
            meta = json.dumps({"step": step, "tensors": tensors,
                               "values": values}).encode()
            _write(os.path.join(tmp, _META), lambda f: f.write(meta))
            if os.path.exists(final):
                shutil.rmtree(final)
            os.replace(tmp, final)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        self._drop_manifest(step)
        self.flush_manifests()
        self._gc()
        return True

    def _gc(self) -> None:
        steps = self.steps_on_disk()
        for step in steps[:max(len(steps) - self._max_to_keep, 0)]:
            shutil.rmtree(self._step_dir(step), ignore_errors=True)
            self._drop_manifest(step)

    def restore(self, step: Optional[int] = None, *, device="cpu",
                verify: bool = True) -> Optional[Any]:
        """The state saved as ``step`` (default: the newest), tensors on
        ``device``; None when nothing is saved. The manifest is verified
        first, before any tensor is loaded."""
        target = step if step is not None else self.latest_step()
        if target is None:
            return None
        if verify:
            self.verify_step(target)
        root = self._step_dir(target)
        with open(os.path.join(root, _META)) as f:
            meta = json.load(f)
        flat = dict(meta["values"])
        for path, rel in meta["tensors"].items():
            flat[path] = torch.load(os.path.join(root, rel),
                                    map_location=device, weights_only=True)
        return T.unflatten(flat)

    def latest_step(self) -> Optional[int]:
        steps = self.steps_on_disk()
        return steps[-1] if steps else None

    def latest_committed_step(self) -> Optional[int]:
        """Newest step on disk. Saves are synchronous and renamed into
        place whole, so every step directory is committed."""
        return self.latest_step()

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

    def _step_files(self, step: int) -> dict[str, dict]:
        root = self._step_dir(step)
        out: dict[str, dict] = {}
        for base, _, files in os.walk(root):
            for fn in files:
                p = os.path.join(base, fn)
                out[os.path.relpath(p, root)] = {
                    "size": os.path.getsize(p), "sha256": _sha256(p)}
        return out

    def flush_manifests(self) -> None:
        """Write a manifest for every step on disk that lacks one."""
        for step in self.steps_on_disk():
            mpath = self._manifest_path(step)
            if os.path.exists(mpath):
                continue
            files = self._step_files(step)
            os.makedirs(os.path.dirname(mpath), exist_ok=True)
            tmp = f"{mpath}.tmp"
            with open(tmp, "w") as f:
                json.dump({"step": step, "files": files}, f)
            os.replace(tmp, mpath)

    def verify_step(self, step: int) -> bool:
        """Check the step's bytes against its manifest. True = verified,
        False = no manifest to verify against. Raises
        ``CheckpointCorruptionError`` on any mismatch."""
        try:
            with open(self._manifest_path(step)) as f:
                manifest = json.load(f)
        except FileNotFoundError:
            return False
        except ValueError as exc:
            raise CheckpointCorruptionError(
                f"step {step}: manifest unreadable: {exc}") from exc
        expect: dict = manifest.get("files", {})
        actual = self._step_files(step)
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

    def wait(self) -> None:
        """Saves are synchronous: nothing is in flight."""

    def close(self) -> None:
        self.flush_manifests()


def resume_from_tiers(managers: list[tuple[str, CheckpointManager]], *,
                      device="cpu"):
    """Restore the newest valid step across checkpoint tiers.

    ``managers`` is ``[(tier_name, manager), ...]`` in preference order for
    equal steps (the trainer passes the emergency tier first). Candidates
    are walked newest first; a step that fails verification or whose
    restore raises is quarantined and the walk falls back to the next
    older one. Returns ``(state, step, tier_name, fallbacks)`` or None when
    no tier holds a restorable step."""
    candidates = []
    for order, (tier, mgr) in enumerate(managers):
        for step in mgr.steps_on_disk():
            candidates.append((step, -order, tier, mgr))
    candidates.sort(key=lambda c: (c[0], c[1]), reverse=True)
    fallbacks = 0
    for step, _, tier, mgr in candidates:
        try:
            state = mgr.restore(step, device=device)
        except Exception as exc:    # corruption, or a torn or unreadable save
            fallbacks += 1
            logger.error("restore fallback: step %d (%s tier) invalid: %s",
                         step, tier, exc)
            mgr.quarantine_step(step)
            continue
        if state is None:
            continue
        return state, step, tier, fallbacks
    return None
