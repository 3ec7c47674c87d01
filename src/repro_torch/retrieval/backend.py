"""Retrieval backends behind one batched protocol — port of ``repro.retrieval.backend``.

Every retriever adapts to :class:`RetrievalBackend`::

    search_batch(queries, query_vecs, k) -> (scores (n, k), ids (n, k))

plus a static :class:`BackendCost` descriptor the routing layer consumes.
Rows are descending, ties resolve to the lowest passage id, and ``k`` is
clamped to the corpus size. Only the exact dense backend is ported; the
BM25, IVF and hybrid backends wait for a later slice.
"""

from __future__ import annotations

import dataclasses
from typing import Protocol, Sequence, runtime_checkable

import torch

from repro_torch.retrieval.chunking import Passage
from repro_torch.retrieval.embedder import Embedder
from repro_torch.retrieval.index import DenseIndex


@dataclasses.dataclass(frozen=True)
class BackendCost:
    """Static per-query cost/quality priors for one retrieval backend."""

    latency_scale: float = 1.0
    recall_prior: float = 1.0
    flops_per_item: float = 0.0

    def __post_init__(self):
        if self.latency_scale <= 0:
            raise ValueError(f"latency_scale must be > 0, got {self.latency_scale}")
        if not (0.0 < self.recall_prior <= 1.0):
            raise ValueError(f"recall_prior must be in (0, 1], got {self.recall_prior}")

    def flops_per_query(self, corpus_size: int) -> float:
        """Total scoring FLOPs one query spends over a corpus of this size."""
        return self.flops_per_item * corpus_size


# Catalog-level defaults by backend name (same values as the JAX package).
DEFAULT_BACKEND_COSTS: dict[str, BackendCost] = {
    "dense": BackendCost(latency_scale=1.0, recall_prior=1.0, flops_per_item=512.0),
    "ivf": BackendCost(latency_scale=0.55, recall_prior=0.81, flops_per_item=256.0),
    "bm25": BackendCost(latency_scale=0.25, recall_prior=0.62, flops_per_item=8.0),
    "hybrid": BackendCost(latency_scale=1.35, recall_prior=1.0, flops_per_item=520.0),
}

_NEUTRAL_COST = BackendCost()


def backend_cost(name: str) -> BackendCost:
    """Static cost descriptor for a backend name (neutral when unknown)."""
    return DEFAULT_BACKEND_COSTS.get(name, _NEUTRAL_COST)


@runtime_checkable
class RetrievalBackend(Protocol):
    """One batched retrieval method the serving layer can route to."""

    name: str
    cost: BackendCost
    requires_query_vecs: bool

    @property
    def size(self) -> int:
        """Corpus passages indexed."""
        ...

    def search_batch(
        self,
        queries: Sequence[str],
        query_vecs: torch.Tensor | None,
        k: int,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """(scores (n, k') float32, ids (n, k') int32), descending per row,
        ties to the lowest passage id, ``k' = min(k, corpus size)``."""
        ...

    def get_passages(self, ids: Sequence[int]) -> list[Passage]:
        """Resolve returned passage ids to their text payloads."""
        ...


class DenseBackend:
    """Exact MIPS through :class:`DenseIndex` (pure delegation). The index
    picks its scorer by its device: the CUDA kernel for a CUDA index, the
    plain blocked scorer for a CPU index."""

    name = "dense"
    requires_query_vecs = True

    def __init__(self, index: DenseIndex):
        self.index = index
        self.cost = BackendCost(
            latency_scale=1.0, recall_prior=1.0, flops_per_item=2.0 * index.dim
        )

    @property
    def size(self) -> int:
        """Corpus passages indexed."""
        return self.index.size

    def search_batch(self, queries, query_vecs, k):
        """Exact MIPS over the full corpus (pure index delegation)."""
        return self.index.search_batch(query_vecs, k)

    def get_passages(self, ids) -> list[Passage]:
        """Resolve passage ids through the wrapped index."""
        return self.index.get_passages(ids)


def make_backends(
    index: DenseIndex,
    passages: Sequence[Passage],
    embedder: Embedder,
    *,
    names: Sequence[str] = ("dense",),
) -> dict[str, RetrievalBackend]:
    """Build the requested backends over one shared corpus (``dense`` only)."""
    backends: dict[str, RetrievalBackend] = {}
    for name in dict.fromkeys(names):  # unique, order-preserving
        if name == "dense":
            backends[name] = DenseBackend(index)
        elif name in ("bm25", "ivf", "hybrid"):
            raise NotImplementedError(f"the {name!r} backend is not ported yet")
        else:
            raise ValueError(
                f"unknown backend {name!r}; make_backends builds 'dense' — pass "
                "custom backends to RAGEngine directly"
            )
    return backends
