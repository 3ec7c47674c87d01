"""Embedding models for dense retrieval — port of ``repro.retrieval.embedder``.

:class:`HashedNGramEmbedder` builds its features on the host in numpy exactly
as the JAX package does (signed feature hashing of word unigrams + char
trigrams, L2-normalized), so the vectors are bit-identical. ``embed`` returns
a float32 CPU tensor; the index moves queries to its own device.
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import Protocol, Sequence

import numpy as np
import torch

from repro_torch.retrieval.tokenizer import char_ngrams, count_tokens, words


class Embedder(Protocol):
    """Anything that embeds texts into unit rows and bills the tokens."""
    dim: int

    def embed(self, texts: Sequence[str]) -> torch.Tensor:  # (n, dim), L2-normed
        """``(n, dim)`` float32 unit rows for ``texts``."""
        ...

    def billed_tokens(self, texts: Sequence[str]) -> int:
        """Embedding tokens billed for ``texts`` (τ_embed, Eq. 2)."""
        ...


def _stable_hash(s: str, salt: str) -> int:
    """Stable across processes/runs (unlike Python's seeded hash())."""
    return int.from_bytes(hashlib.blake2b((salt + s).encode(), digest_size=8).digest(), "little")


class HashedNGramEmbedder:
    """Signed feature hashing: words + char-3grams → R^dim, L2 normalized."""

    def __init__(self, dim: int = 256, *, ngram: int = 3, word_weight: float = 2.0, ngram_weight: float = 0.5):
        if dim <= 0:
            raise ValueError("dim must be positive")
        self.dim = dim
        self.ngram = ngram
        self.word_weight = word_weight
        self.ngram_weight = ngram_weight

    def _features(self, text: str) -> np.ndarray:
        v = np.zeros((self.dim,), np.float32)
        for w in words(text):
            h = _stable_hash(w, "w")
            sign = 1.0 if (h >> 62) & 1 else -1.0
            v[h % self.dim] += sign * self.word_weight
        for g in char_ngrams(text, self.ngram):
            h = _stable_hash(g, "g")
            sign = 1.0 if (h >> 62) & 1 else -1.0
            v[h % self.dim] += sign * self.ngram_weight
        return v

    def embed(self, texts: Sequence[str]) -> torch.Tensor:
        """``(n, dim)`` float32 unit rows for ``texts``."""
        if len(texts) == 0:
            return torch.zeros((0, self.dim), dtype=torch.float32)
        mat = np.stack([self._features(t) for t in texts])
        norms = np.linalg.norm(mat, axis=-1, keepdims=True)
        mat = mat / np.maximum(norms, 1e-9)
        return torch.from_numpy(np.ascontiguousarray(mat, np.float32))

    def billed_tokens(self, texts: Sequence[str]) -> int:
        """Embedding tokens billed for ``texts`` (τ_embed, Eq. 2)."""
        return sum(count_tokens(t) for t in texts)


class CachingEmbedder:
    """Memoizing wrapper: text → embedding-row cache (bounded, FIFO-evicted).

    Billing stays per call; compute is deduplicated. Rows are cached as numpy
    and reassembled per request, so a text's vector is identical whether it
    was first seen alone or inside a batch.
    """

    def __init__(self, base: Embedder, *, max_entries: int = 65536):
        if max_entries <= 0:
            raise ValueError("max_entries must be positive")
        self.base = base
        self.dim = base.dim
        self.max_entries = max_entries
        self._cache: OrderedDict[str, np.ndarray] = OrderedDict()
        self.hits = 0
        self.misses = 0

    def embed(self, texts: Sequence[str]) -> torch.Tensor:
        """``(n, dim)`` float32 unit rows for ``texts``."""
        if len(texts) == 0:
            return torch.zeros((0, self.dim), dtype=torch.float32)
        missing: list[str] = []
        seen: set[str] = set()
        for t in texts:
            if t not in self._cache and t not in seen:
                missing.append(t)
                seen.add(t)
        self.misses += len(missing)
        self.hits += len(texts) - len(missing)
        if missing:
            rows = np.asarray(self.base.embed(missing), np.float32)
            for t, row in zip(missing, rows):
                self._cache[t] = row
        # snapshot before eviction so every requested row survives this call
        out = torch.from_numpy(np.stack([self._cache[t] for t in texts]))
        while len(self._cache) > self.max_entries:
            self._cache.popitem(last=False)
        return out

    def billed_tokens(self, texts: Sequence[str]) -> int:
        """Embedding tokens billed for ``texts`` (τ_embed, Eq. 2)."""
        return self.base.billed_tokens(texts)
