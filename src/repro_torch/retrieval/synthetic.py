"""Seeded synthetic corpora for retrieval-scaling runs — port of
``repro.retrieval.synthetic``.

Rows are ``default_rng(seed)`` Gaussians, L2-normalized on the host in
float32 exactly as the JAX package makes them, then installed on the index's
device with ``assume_normalized=True``: the same ``(n_docs, dim, seed)``
gives bit-identical rows in both packages. Retrieval *quality* over such a
corpus is meaningless; it exists to measure systems behaviour at scale.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.retrieval.chunking import Passage
from repro_torch.retrieval.index import DenseIndex


def synthetic_dense_index(
    n_docs: int,
    dim: int = 64,
    *,
    seed: int = 0,
    with_passages: bool = True,
    device: str | torch.device = "cuda",
) -> DenseIndex:
    """Build a seeded synthetic :class:`DenseIndex` with ``n_docs`` rows on ``device``."""
    if n_docs < 1:
        raise ValueError(f"n_docs must be >= 1, got {n_docs}")
    if dim < 1:
        raise ValueError(f"dim must be >= 1, got {dim}")
    rng = np.random.default_rng(seed)
    emb = rng.standard_normal((n_docs, dim), dtype=np.float32)
    norms = np.maximum(np.linalg.norm(emb, axis=1, keepdims=True), 1e-9)
    emb = (emb / norms).astype(np.float32)
    passages = (
        [Passage(i, f"synthetic document {i}") for i in range(n_docs)]
        if with_passages
        else None
    )
    return DenseIndex(emb, passages, assume_normalized=True, device=device)
