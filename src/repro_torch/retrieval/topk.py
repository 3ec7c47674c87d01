"""Top-k primitives with the lowest-index tie rule — port of ``repro.retrieval.topk``.

``lax.top_k`` keeps the first of equal values. ``torch.topk`` makes no such
promise, so these select with a *stable* descending sort: equal scores keep
their column order, i.e. resolve to the lowest index.
"""

from __future__ import annotations

import torch


def _stable_topk(scores: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def blocked_topk(
    scores: torch.Tensor, k: int, *, block: int = 4096
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k over the last axis, streaming ``block``-wide column chunks with a
    running candidate set of size k. Returns (values, int32 indices), descending."""
    n = scores.shape[-1]
    if k > n:
        raise ValueError(f"k={k} > n={n}")
    if n <= block:
        v, i = _stable_topk(scores, k)
        return v, i.to(torch.int32)
    vals = idxs = None
    for start in range(0, n, block):
        bv, bi = _stable_topk(scores[..., start : start + block], k)
        bi = bi + start
        if vals is None:
            vals, idxs = bv, bi
        else:
            # running list first: on a tie it holds the lower column indices
            vals, idxs = merge_topk(vals, idxs, bv, bi, k)
    return vals, idxs.to(torch.int32)


def merge_topk(
    vals_a: torch.Tensor, idx_a: torch.Tensor, vals_b: torch.Tensor, idx_b: torch.Tensor, k: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Merge two candidate lists into one descending top-k (ties: list a first)."""
    cat_v = torch.cat([vals_a, vals_b], dim=-1)
    cat_i = torch.cat([idx_a, idx_b], dim=-1)
    v, sel = _stable_topk(cat_v, k)
    return v, torch.gather(cat_i, -1, sel)
