"""Train-side input staging (port of ``kubeflow_tpu/train/staging.py``).

``DeviceBatchStager`` builds batch N+1 on a background thread while step N
runs. On a card, ``to_device`` copies each batch from pinned host memory
with ``non_blocking=True`` on a side stream and records an event;
``StagedBatch.ready()`` makes the consuming stream wait for that event
before the batch is used, so the copy overlaps the step and is never read
half-written.

``stage_inputs`` copies a dataset (and tokenizer) from a bare path or a
``file://`` URI into the job dir before the data pipeline starts, and can
train a BPE tokenizer from the staged text. The artifact-store schemes of
the JAX package (``artifact://``, ``cas://``) are not ported.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import queue
import shutil
import threading
from typing import Any, Callable, Optional

import numpy as np
import torch

logger = logging.getLogger("kubeflow_tpu_torch.train")


@dataclasses.dataclass
class StagedBatch:
    """A batch on its device, with the event its copy recorded (None on
    the CPU, where the copy is synchronous)."""

    tensor: torch.Tensor
    event: Optional[torch.cuda.Event] = None

    def ready(self) -> torch.Tensor:
        """The tensor, once the current stream has waited for its copy."""
        if self.event is not None:
            stream = torch.cuda.current_stream(self.tensor.device)
            stream.wait_event(self.event)
            # The caching allocator must not hand the memory back to the
            # side stream while the compute stream still reads it.
            self.tensor.record_stream(stream)
        return self.tensor


def to_device(arr: np.ndarray, device: torch.device,
              stream: Optional["torch.cuda.Stream"] = None) -> StagedBatch:
    """``arr`` onto ``device``: pinned host copy, then a non-blocking copy
    on ``stream`` (a side stream) and an event recorded after it."""
    host = torch.from_numpy(np.ascontiguousarray(arr))
    if device.type != "cuda":
        return StagedBatch(host.to(device))
    host = host.pin_memory()
    stream = stream or torch.cuda.current_stream(device)
    with torch.cuda.stream(stream):
        out = host.to(device, non_blocking=True)
        event = torch.cuda.Event()
        event.record(stream)
    return StagedBatch(out, event)


class DeviceBatchStager:
    """Double-buffered host→device input staging for the train loop.

    ``fetch(index)`` (build the batch, ``to_device``) runs on a background
    thread up to ``depth`` batches ahead. ``fetch`` must be a pure function
    of the index (the data fast-forward contract), which keeps prefetching
    restart-transparent. Consumption is strictly sequential from
    ``start``; ``get`` checks the index. Always ``close()`` (or use as a
    context manager)."""

    def __init__(self, fetch: Callable[[int], Any], *, start: int = 0,
                 depth: int = 2, name: str = "batch-stager"):
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        self._fetch = fetch
        self._start = start
        # The queue is the only cross-thread channel (items and errors);
        # the stop event is the only other shared state.
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=name)
        self._thread.start()

    def _run(self) -> None:
        i = self._start
        while not self._stop.is_set():
            try:
                item = ("ok", i, self._fetch(i))
            except BaseException as exc:
                # Logged here and forwarded: get() raises it on the
                # consumer thread, so the loop fails loudly.
                logger.warning("batch staging failed at index %d: %s", i, exc)
                item = ("err", i, exc)
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.1)
                    break
                except queue.Full:
                    continue
            if item[0] == "err":
                return
            i += 1

    def get(self, index: int, timeout: Optional[float] = None) -> Any:
        """The staged batch for ``index`` (must be consumed in order); a
        ``StagedBatch`` is returned ready for the current stream."""
        kind, i, payload = self._q.get(timeout=timeout)
        if kind == "err":
            raise RuntimeError(
                f"batch staging failed at index {i}") from payload
        if i != index:
            raise RuntimeError(
                f"batch stager is at index {i} but caller asked for "
                f"{index}; consumption must be sequential from start")
        return payload.ready() if isinstance(payload, StagedBatch) else payload

    def close(self) -> None:
        self._stop.set()
        # Unblock a put()-blocked producer so the thread exits promptly.
        try:
            self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5.0)

    def __enter__(self) -> "DeviceBatchStager":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _resolve(uri: str) -> str:
    if uri.startswith("file://"):
        return uri[len("file://"):]
    if "://" in uri:
        raise ValueError(f"unsupported staging scheme in {uri!r} "
                         "(file:// or a bare path)")
    return uri


def _same_mtime(dst: str, src: str) -> bool:
    """The staged copy carries the source's mtime (copy2), within the 2 s
    of the coarsest filesystems."""
    return abs(os.path.getmtime(dst) - os.path.getmtime(src)) < 2.0


def _stage_file(src: str, staged: str) -> str:
    dst = os.path.join(staged, os.path.basename(src))
    if not (os.path.exists(dst)
            and os.path.getsize(dst) == os.path.getsize(src)
            and _same_mtime(dst, src)):
        shutil.copy2(src, dst)
    return dst


def stage_inputs(workdir: str, *, dataset_uri: Optional[str] = None,
                 tokenizer_uri: Optional[str] = None,
                 train_tokenizer_vocab: Optional[int] = None) -> dict:
    """Copy inputs into ``<workdir>/staged`` and return their local paths:
    ``{"dataset": path|None, "tokenizer": path|None}``. Idempotent."""
    staged = os.path.join(workdir, "staged")
    os.makedirs(staged, exist_ok=True)
    out: dict = {"dataset": None, "tokenizer": None}
    if dataset_uri:
        out["dataset"] = _stage_file(_resolve(dataset_uri), staged)
    if tokenizer_uri:
        out["tokenizer"] = _stage_file(_resolve(tokenizer_uri), staged)
    elif train_tokenizer_vocab and out["dataset"]:
        from kubeflow_tpu_torch.serve.tokenizer import BPETokenizer

        dst = os.path.join(staged, "tokenizer.bpe.json")
        if not (os.path.exists(dst)
                and os.path.getmtime(dst) >= os.path.getmtime(out["dataset"])):
            with open(out["dataset"], errors="replace") as f:
                tok = BPETokenizer.train(f.read(), train_tokenizer_vocab)
            tok.save(dst + ".tmp")
            os.replace(dst + ".tmp", dst)
        out["tokenizer"] = dst
    return out
