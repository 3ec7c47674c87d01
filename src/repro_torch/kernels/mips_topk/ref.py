"""Plain PyTorch versions of the ``mips_topk`` kernel's two passes.

Contract (as ``repro/kernels/mips_topk/ref.py``): queries (Q, D), corpus
(N, D) → (scores (Q, k) float32 descending, ids (Q, k) int32); inputs are
upcast to float32 and equal scores resolve to the lower row id. Used on the
CPU, by the tests and by ``chip_smoke.py``'s comparisons; nothing on the
CUDA path calls it.
"""

from __future__ import annotations

import torch

# id of an empty candidate slot in pass 1 (the kernel's sentinel)
EMPTY_ID = 2**31 - 1


def score_matrix(queries, corpus, n_valid=None, mask=None) -> torch.Tensor:
    """(Q, N') float32 scores; rows past ``n_valid`` dropped, masked rows -inf."""
    scores = queries.float() @ corpus.float().T  # (Q, N)
    if n_valid is not None:
        scores = scores[:, :n_valid]
    if mask is not None:
        scores = scores.masked_fill(~(mask > 0), float("-inf"))
    return scores


def mips_topk_ref(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    k: int,
    *,
    n_valid: int | None = None,
    mask: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """q·cᵀ, then a stable descending sort: ties keep the lower id first."""
    scores = score_matrix(queries, corpus, n_valid, mask)
    vals, idx = torch.sort(scores, dim=1, descending=True, stable=True)
    return vals[:, :k].contiguous(), idx[:, :k].to(torch.int32).contiguous()


def select_ref(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    k: int,
    rows_per_split: int,
    *,
    n_valid: int | None = None,
    mask: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Pass 1: each split's top-k, (Q, splits, k). Rows that are masked out
    never fill a slot; unfilled slots are (-inf, EMPTY_ID)."""
    scores = score_matrix(queries, corpus, n_valid, mask)
    q, n = scores.shape
    splits = -(-n // rows_per_split)
    pad = splits * rows_per_split - n
    valid = torch.ones_like(scores, dtype=torch.bool)
    if mask is not None:
        valid = valid & (mask > 0)[None, :]
    if pad:
        scores = torch.nn.functional.pad(scores, (0, pad), value=float("-inf"))
        valid = torch.nn.functional.pad(valid, (0, pad), value=False)
    scores = scores.view(q, splits, rows_per_split)
    valid = valid.view(q, splits, rows_per_split)
    vals, idx = torch.sort(scores, dim=2, descending=True, stable=True)
    vals, idx = vals[..., :k], idx[..., :k]
    filled = torch.gather(valid, 2, idx)
    base = torch.arange(splits, device=scores.device).view(1, splits, 1) * rows_per_split
    ids = torch.where(filled, idx + base, torch.full_like(idx, EMPTY_ID))
    vals = torch.where(filled, vals, torch.full_like(vals, float("-inf")))
    return vals.contiguous(), ids.to(torch.int32).contiguous()


def merge_ref(cand_v: torch.Tensor, cand_i: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Pass 2: (Q, W) candidates → (Q, k) by (score descending, id ascending);
    empty slots come out with id -1. (Q, S, k) input is read as (Q, S*k)."""
    cand_v = cand_v.reshape(cand_v.shape[0], -1)
    cand_i = cand_i.reshape(cand_i.shape[0], -1)
    by_id = torch.sort(cand_i.to(torch.int64), dim=1, stable=True).indices
    v = torch.gather(cand_v, 1, by_id)
    i = torch.gather(cand_i, 1, by_id)
    order = torch.sort(v, dim=1, descending=True, stable=True).indices[:, :k]
    out_v = torch.gather(v, 1, order)
    out_i = torch.gather(i, 1, order)
    out_i = torch.where(out_i == EMPTY_ID, torch.full_like(out_i, -1), out_i)
    return out_v.contiguous(), out_i.contiguous()
