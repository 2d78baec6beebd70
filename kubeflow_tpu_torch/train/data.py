"""Training data: deterministic synthetic token streams, packed text and
windows of an on-disk token array (the ``grain`` kind, without grain) (port
of ``kubeflow_tpu/train/data.py``).

Batches are numpy arrays, built exactly as the JAX package builds them, so
the same ``(seed, step)`` gives the same tokens in both packages; the train
loop stages them onto the device (``train/staging.py``). A batch is a pure
function of the step, which is what lets a restarted run fast-forward.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import uuid
from typing import Iterator, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    kind: str = "synthetic"        # synthetic | text | grain
    vocab_size: int = 256
    seq_len: int = 128
    global_batch: int = 8
    seed: int = 0
    path: Optional[str] = None     # text: raw text file; grain: a .npy
    # text kind: tokenizer name from the registry ("byte") or a BPE json
    # path (serve/tokenizer.py BPETokenizer artifact).
    tokenizer: str = "byte"
    tokenizer_path: Optional[str] = None


def _local_batch(cfg: DataConfig, num_shards: int) -> int:
    if cfg.global_batch % num_shards:
        raise ValueError(f"global_batch {cfg.global_batch} not divisible by "
                         f"num_shards {num_shards}")
    return cfg.global_batch // num_shards


class SyntheticLM:
    """Markov-ish synthetic LM data: next token = (3*tok + 7) % V, with 5%
    noise. Learnable by a tiny model in a few hundred steps, deterministic
    per (seed, step, shard)."""

    def __init__(self, cfg: DataConfig, shard: int = 0, num_shards: int = 1):
        self.cfg = cfg
        self.shard = shard
        self.num_shards = num_shards
        self.local_batch = _local_batch(cfg, num_shards)

    def batch_at(self, step: int) -> np.ndarray:
        """[local_batch, seq_len+1] int32 tokens for this shard at `step`."""
        rng = np.random.default_rng([self.cfg.seed, step, self.shard])
        b, s, v = self.local_batch, self.cfg.seq_len + 1, self.cfg.vocab_size
        toks = np.empty((b, s), np.int32)
        toks[:, 0] = rng.integers(0, v, b)
        noise = (rng.random((b, s)) < 0.05)
        rand = rng.integers(0, v, (b, s))
        for t in range(1, s):
            nxt = (3 * toks[:, t - 1] + 7) % v
            toks[:, t] = np.where(noise[:, t], rand[:, t], nxt)
        return toks

    def iterate(self, start_step: int = 0) -> Iterator[np.ndarray]:
        step = start_step
        while True:
            yield self.batch_at(step)
            step += 1


def stacked_batches(source, step0: int, k: int) -> np.ndarray:
    """[K, local_batch, seq_len+1]: the batches of steps step0..step0+K-1,
    for ``multi_step_fn``."""
    return np.stack([source.batch_at(step0 + j) for j in range(k)])


class TextLM:
    """Raw text → tokenizer → packed ``seq_len+1`` windows → batches.

    The text is tokenized once and cached beside it as
    ``<path>.<tag>.tokens.npy``. Windows are visited in a permutation drawn
    per epoch from ``(seed, epoch)``: random access by global step, so a
    restarted run fast-forwards exactly. The JAX package shuffles with
    grain, which the port does not use, so the two packages visit windows
    in different orders."""

    def __init__(self, cfg: DataConfig, shard: int = 0, num_shards: int = 1):
        if not cfg.path:
            raise ValueError("text data source needs DataConfig.path")
        self.cfg = cfg
        self.shard = shard
        self.num_shards = num_shards
        self.local_batch = _local_batch(cfg, num_shards)
        self.tokens = self._tokenize_cached()
        if int(self.tokens.max(initial=0)) >= cfg.vocab_size:
            raise ValueError(
                f"tokenized data has ids up to {int(self.tokens.max())} but "
                f"the data config vocab is {cfg.vocab_size}")
        s = cfg.seq_len + 1
        if len(self.tokens) < s:
            raise ValueError(
                f"text at {cfg.path} tokenizes to {len(self.tokens)} tokens "
                f"— need at least seq_len+1 = {s} for one window")
        self.per_epoch = (len(self.tokens) - 1) // s or 1

    def _tokenize_cached(self) -> np.ndarray:
        from kubeflow_tpu_torch.serve.tokenizer import (
            BPETokenizer, get_tokenizer,
        )

        if self.cfg.tokenizer_path:
            tok = BPETokenizer.load(self.cfg.tokenizer_path)
            with open(self.cfg.tokenizer_path, "rb") as f:
                tag = "bpe-" + hashlib.sha256(f.read()).hexdigest()[:8]
        else:
            tok = get_tokenizer(self.cfg.tokenizer)
            tag = self.cfg.tokenizer
        cache = f"{self.cfg.path}.{tag}.tokens.npy"
        if os.path.exists(cache) and (os.path.getmtime(cache)
                                      >= os.path.getmtime(self.cfg.path)):
            return np.load(cache, mmap_mode="r")
        with open(self.cfg.path, errors="replace") as f:
            arr = np.asarray(tok.encode(f.read()), np.int32)
        # A name unique per writer, then an atomic rename: racing writers
        # never interleave, and a failed write leaves no orphan.
        tmp = f"{cache}.{os.getpid()}.{uuid.uuid4().hex[:8]}.tmp"
        try:
            with open(tmp, "wb") as f:
                np.save(f, arr)
            os.replace(tmp, cache)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        return np.load(cache, mmap_mode="r")

    def _window(self, i: int) -> int:
        epoch, j = divmod(i, self.per_epoch)
        perm = np.random.default_rng([self.cfg.seed, epoch]).permutation(
            self.per_epoch)
        return int(perm[j])

    def batch_at(self, step: int) -> np.ndarray:
        """[local_batch, seq_len+1] for this shard at global ``step``."""
        s = self.cfg.seq_len + 1
        out = np.empty((self.local_batch, s), np.int32)
        base = step * self.cfg.global_batch + self.shard * self.local_batch
        for j in range(self.local_batch):
            w = self._window(base + j)
            out[j] = self.tokens[w * s:(w + 1) * s]
        return out

    def iterate(self, start_step: int = 0) -> Iterator[np.ndarray]:
        step = start_step
        while True:
            yield self.batch_at(step)
            step += 1


class GrainLM:
    """The ``grain`` kind: windows of an on-disk token array (``np.save``
    of a 1-D integer array at ``cfg.path``), picked per ``(seed, step,
    shard)`` — the JAX package's ``_grain_source`` exactly. That source
    imports google/grain only to check that it is installed; its batches
    are plain numpy, so this one imports no grain."""

    def __init__(self, cfg: DataConfig, shard: int = 0, num_shards: int = 1):
        self.cfg = cfg
        self.shard = shard
        self.tokens = np.load(cfg.path, mmap_mode="r")
        self.local_batch = cfg.global_batch // num_shards
        self.per_epoch = max(1, (len(self.tokens) - 1) // (cfg.seq_len + 1))

    def batch_at(self, step: int) -> np.ndarray:
        """[local_batch, seq_len+1] int32 windows for this shard at
        ``step``."""
        rng = np.random.default_rng((self.cfg.seed, step, self.shard))
        idx = rng.integers(0, self.per_epoch, self.local_batch)
        s = self.cfg.seq_len + 1
        return np.stack([self.tokens[i * s:(i + 1) * s]
                         for i in idx]).astype(np.int32)

    def iterate(self, start_step: int = 0) -> Iterator[np.ndarray]:
        step = start_step
        while True:
            yield self.batch_at(step)
            step += 1


def make_data_source(cfg: DataConfig, shard: int = 0, num_shards: int = 1):
    if cfg.kind == "synthetic":
        return SyntheticLM(cfg, shard, num_shards)
    if cfg.kind == "text":
        return TextLM(cfg, shard, num_shards)
    if cfg.kind == "grain":
        return GrainLM(cfg, shard, num_shards)
    raise ValueError(f"unknown data kind {cfg.kind!r}")
