"""Tokenizers for the serving path (a copy of
``kubeflow_tpu/serve/tokenizer.py``).

The platform ships a dependency-free byte tokenizer (utf-8 bytes + specials)
so the full serving stack runs hermetically — the analog of the reference
runtime's bundled tokenizer download, which needs network ((U) kserve
python/huggingfaceserver model load path). Real deployments register their
own via ``register_tokenizer``.
"""

from __future__ import annotations

from typing import Callable, Protocol


class Tokenizer(Protocol):
    bos_id: int
    eos_id: int
    vocab_size: int

    def encode(self, text: str) -> list[int]: ...
    def decode(self, ids: list[int]) -> str: ...


class ByteTokenizer:
    """utf-8 bytes shifted by 3: 0=pad, 1=bos, 2=eos. Vocab 259."""

    PAD, BOS, EOS = 0, 1, 2
    OFFSET = 3

    bos_id = BOS
    eos_id = EOS
    vocab_size = 256 + OFFSET

    def encode(self, text: str) -> list[int]:
        return [self.BOS] + [b + self.OFFSET for b in text.encode("utf-8")]

    def decode(self, ids: list[int]) -> str:
        # Ids outside the byte range (specials below, or tokens a larger-
        # vocab model emitted above 258) have no byte meaning: drop them.
        data = bytes(i - self.OFFSET for i in ids
                     if self.OFFSET <= i < self.vocab_size)
        return data.decode("utf-8", "replace")


class BPETokenizer:
    """Byte-level BPE trained from a corpus — the real-tokenizer path (the
    reference stages a pretrained HF tokenizer via its storage-initializer;
    hermetically we TRAIN one from the user's text and stage the json).

    Merges operate on byte ids (+3 specials, matching ByteTokenizer's id
    layout so byte-level models stay compatible); ``train`` runs classic
    greedy pair-merge counting, ``encode`` applies merges by rank."""

    PAD, BOS, EOS = 0, 1, 2
    OFFSET = 3

    bos_id = BOS
    eos_id = EOS

    def __init__(self, merges: list[tuple[int, int]] | None = None):
        self.merges: list[tuple[int, int]] = [tuple(m) for m in merges or []]
        self._rebuild()

    def _rebuild(self) -> None:
        self.vocab_size = 256 + self.OFFSET + len(self.merges)
        self._rank = {tuple(m): i for i, m in enumerate(self.merges)}
        # merged id -> constituent byte ids (for decode)
        self._expand: dict[int, list[int]] = {}
        base = 256 + self.OFFSET
        for i, (a, b) in enumerate(self.merges):
            left = self._expand.get(a, [a])
            right = self._expand.get(b, [b])
            self._expand[base + i] = left + right

    # -- training ----------------------------------------------------------

    @classmethod
    def train(cls, text: str, vocab_size: int) -> "BPETokenizer":
        import collections

        base = 256 + cls.OFFSET
        n_merges = max(0, vocab_size - base)
        # Word-split keeps merges inside whitespace-delimited chunks (the
        # usual BPE pre-tokenization), which keeps training near-linear.
        words = collections.Counter(
            tuple(b + cls.OFFSET for b in w.encode("utf-8"))
            for w in text.split())
        merges: list[tuple[int, int]] = []
        for mi in range(n_merges):
            pairs: collections.Counter = collections.Counter()
            for word, cnt in words.items():
                for a, b in zip(word, word[1:]):
                    pairs[(a, b)] += cnt
            if not pairs:
                break
            best, cnt = pairs.most_common(1)[0]
            if cnt < 2:
                break
            merges.append(best)
            new_id = base + mi
            merged = {}
            for word, cnt in words.items():
                out, i = [], 0
                while i < len(word):
                    if (i + 1 < len(word)
                            and (word[i], word[i + 1]) == best):
                        out.append(new_id)
                        i += 2
                    else:
                        out.append(word[i])
                        i += 1
                merged[tuple(out)] = merged.get(tuple(out), 0) + cnt
            words = collections.Counter(merged)
        return cls(merges)

    # -- encode/decode -----------------------------------------------------

    def _apply_merges(self, ids: list[int]) -> list[int]:
        base = 256 + self.OFFSET
        while len(ids) > 1:
            best_rank, best_i = None, -1
            for i, pair in enumerate(zip(ids, ids[1:])):
                r = self._rank.get(pair)
                if r is not None and (best_rank is None or r < best_rank):
                    best_rank, best_i = r, i
            if best_rank is None:
                return ids
            ids = (ids[:best_i] + [base + best_rank]
                   + ids[best_i + 2:])
        return ids

    def encode(self, text: str) -> list[int]:
        out = [self.BOS]
        words = text.split(" ")
        for i, w in enumerate(words):
            out.extend(self._apply_merges(
                [b + self.OFFSET for b in w.encode("utf-8")]))
            if i < len(words) - 1:   # exactly the separators the text had
                out.extend(self._apply_merges([32 + self.OFFSET]))
        return out

    def decode(self, ids: list[int]) -> str:
        flat: list[int] = []
        for i in ids:
            if i in self._expand:
                flat.extend(self._expand[i])
            elif self.OFFSET <= i < 256 + self.OFFSET:
                flat.append(i)
        return bytes(b - self.OFFSET for b in flat).decode("utf-8", "replace")

    # -- persistence (the staged artifact) ---------------------------------

    def save(self, path: str) -> None:
        import json

        with open(path, "w") as f:
            json.dump({"kind": "bpe", "merges": self.merges}, f)

    @classmethod
    def load(cls, path: str) -> "BPETokenizer":
        import json

        with open(path) as f:
            doc = json.load(f)
        return cls([tuple(m) for m in doc["merges"]])


_registry: dict[str, Callable[[], Tokenizer]] = {"byte": ByteTokenizer}


def register_tokenizer(name: str, factory: Callable[[], Tokenizer]) -> None:
    _registry[name] = factory


def get_tokenizer(name: str = "byte") -> Tokenizer:
    if name not in _registry:
        raise KeyError(f"unknown tokenizer {name!r}; known: {sorted(_registry)}")
    return _registry[name]()
