"""Dense MIPS retrieval index — port of ``repro.retrieval.index``.

``DenseIndex`` holds L2-normalized passage embeddings on its device, so inner
product == cosine similarity. Two scorers:

* ``"blocked"`` — the plain path: per fixed ``Q_BLOCK`` chunk of queries, a
  matmul against the corpus and a running top-k (``topk.blocked_topk``). It
  is the default for a CPU index. The fixed, zero-padded chunk shape keeps
  every row's result independent of the caller's batch size.
* ``"kernel"`` — the hand-written CUDA ``mips_topk`` kernel, the default for
  a CUDA index. One ``search_batch`` call makes one launch of each kernel
  pass for all its rows; the kernel's fixed per-score reduction order makes a
  row's result independent of the batch it rides in.

``"blocked"`` on a CUDA index runs only when asked for by name; ``"kernel"``
on a CPU index raises.

Queries are re-normalized on the host, in fixed ``Q_BLOCK`` chunks, before
they reach either scorer, so both scorers see bit-identical query rows.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.mips_topk.ops import mips_topk
from repro_torch.retrieval.chunking import Passage
from repro_torch.retrieval.embedder import Embedder
from repro_torch.retrieval.topk import blocked_topk

# Fixed query-block width of the plain scorer and of query normalization;
# every search is padded to a multiple of it (as in the JAX package).
Q_BLOCK = 8

SCORERS = ("blocked", "kernel")


@dataclasses.dataclass(frozen=True)
class SearchResult:
    """Hits for one query, descending by score."""

    passage_ids: np.ndarray  # (k,) int32
    scores: np.ndarray  # (k,) float32

    @property
    def confidence(self) -> float:
        """Max cosine similarity — the paper's retrieval confidence."""
        return float(self.scores[0]) if self.scores.size else float("nan")


def l2_normalize(x: torch.Tensor, eps: float = 1e-9) -> torch.Tensor:
    """Rows of ``x`` scaled to unit L2 norm (norms floored at ``eps``)."""
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=eps)


class DenseIndex:
    """Exact MIPS index over passage embeddings, resident on ``device``."""

    def __init__(
        self,
        embeddings: np.ndarray | torch.Tensor,
        passages: Sequence[Passage] | None = None,
        *,
        assume_normalized: bool = False,
        device: str | torch.device = "cuda",
    ):
        self.device = resolve_device(device)
        emb = torch.as_tensor(embeddings, dtype=torch.float32)
        if emb.ndim != 2:
            raise ValueError(f"embeddings must be (n, d), got {tuple(emb.shape)}")
        # assume_normalized: the rows are already unit-norm; re-normalizing
        # would perturb last-bit floats.
        if not assume_normalized:
            emb = l2_normalize(emb)
        self.embeddings = emb.to(self.device).contiguous()
        self.passages = list(passages) if passages is not None else None
        if self.passages is not None and len(self.passages) != emb.shape[0]:
            raise ValueError("passages/embeddings length mismatch")

    @classmethod
    def build(
        cls,
        passages: Sequence[Passage],
        embedder: Embedder,
        *,
        device: str | torch.device = "cuda",
    ) -> tuple["DenseIndex", int]:
        """Embed passages once and build the index. Returns (index,
        index_embedding_tokens) — the offline billing bookkeeping of §V.D."""
        texts = [p.text for p in passages]
        emb = embedder.embed(texts)
        return cls(emb, passages, device=device), embedder.billed_tokens(texts)

    @property
    def size(self) -> int:
        """Number of indexed passages."""
        return self.embeddings.shape[0]

    @property
    def dim(self) -> int:
        """Embedding width."""
        return self.embeddings.shape[1]

    def normalize_queries(self, query_vecs) -> torch.Tensor:
        """Host float32 queries, zero-padded to a Q_BLOCK multiple and
        normalized one fixed-shape chunk at a time (what both scorers search)."""
        q = torch.as_tensor(query_vecs, dtype=torch.float32).cpu()
        pad = (-q.shape[0]) % Q_BLOCK
        if pad:
            q = torch.cat([q, torch.zeros((pad, q.shape[1]), dtype=torch.float32)])
        return torch.cat([l2_normalize(q[s : s + Q_BLOCK]) for s in range(0, q.shape[0], Q_BLOCK)])

    def search_batch(
        self, query_vecs, k: int, *, scorer: str | None = None
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """(nq, d) → (scores (nq, k) float32, ids (nq, k) int32) on the index's
        device, descending per row, ties to the lowest id. ``k`` is clamped to
        the corpus size."""
        if scorer is None:
            scorer = "kernel" if self.device.type == "cuda" else "blocked"
        if scorer not in SCORERS:
            raise ValueError(f"unknown scorer {scorer!r}; expected one of {SCORERS}")
        k = min(k, self.size)
        if query_vecs.ndim != 2:
            raise ValueError(f"query_vecs must be (nq, d), got {tuple(query_vecs.shape)}")
        nq = query_vecs.shape[0]
        if nq == 0:
            return (
                torch.zeros((0, k), dtype=torch.float32, device=self.device),
                torch.zeros((0, k), dtype=torch.int32, device=self.device),
            )
        q = self.normalize_queries(query_vecs)
        if scorer == "kernel":
            if self.device.type != "cuda":
                raise RuntimeError("scorer='kernel' needs a CUDA index; this one is on the CPU")
            return mips_topk(q[:nq].to(self.device), self.embeddings, k)
        q = q.to(self.device)
        emb_t = self.embeddings.T
        outs = [blocked_topk(q[s : s + Q_BLOCK] @ emb_t, k) for s in range(0, q.shape[0], Q_BLOCK)]
        vals = torch.cat([v for v, _ in outs])[:nq]
        ids = torch.cat([i for _, i in outs])[:nq]
        return vals, ids

    def search(self, query_vec, k: int, *, scorer: str | None = None) -> SearchResult:
        """Single-query wrapper over :meth:`search_batch`."""
        scores, ids = self.search_batch(
            torch.as_tensor(query_vec)[None, :], k, scorer=scorer
        )
        return SearchResult(
            ids[0].cpu().numpy().astype(np.int32), scores[0].cpu().numpy().astype(np.float32)
        )

    def get_passages(self, ids: Sequence[int]) -> list[Passage]:
        """Resolve passage ids to their payloads."""
        if self.passages is None:
            raise ValueError("index built without passage payloads")
        return [self.passages[int(i)] for i in ids]
