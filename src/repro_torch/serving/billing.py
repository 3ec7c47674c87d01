"""Token billing (paper §V.D, Eq. 2) with a cumulative ledger.

    τ_billed = τ_prompt + τ_completion + τ_embed

Offline corpus indexing bills separately (``index_embedding_tokens``) so
per-query cost never hides amortized index cost (§V.D) — but it is tracked,
because ignoring embedding tokens "would undercount per-query cost by
approximately 8–12 tokens" (§VII.B applies the same discipline per query).
"""

from __future__ import annotations

import dataclasses

from repro_torch.retrieval.tokenizer import count_tokens


@dataclasses.dataclass(frozen=True)
class TokenBill:
    """Billed tokens of one query (Eq. 2 terms)."""
    prompt_tokens: int
    completion_tokens: int
    embedding_tokens: int

    @property
    def total(self) -> int:
        """τ_billed = τ_prompt + τ_completion + τ_embed."""
        return self.prompt_tokens + self.completion_tokens + self.embedding_tokens


def bill_query(prompt: str, completion: str, embedded_texts: list[str]) -> TokenBill:
    """Token bill of one prompt, its completion and the embedded texts."""
    return TokenBill(
        prompt_tokens=count_tokens(prompt),
        completion_tokens=count_tokens(completion),
        embedding_tokens=sum(count_tokens(t) for t in embedded_texts),
    )


class BillingLedger:
    """Cumulative run accounting (drives Fig. 4's cumulative-token audit)."""

    def __init__(self, index_embedding_tokens: int = 0):
        self.index_embedding_tokens = index_embedding_tokens
        self.bills: list[TokenBill] = []

    def add(self, bill: TokenBill) -> None:
        """Append one query's bill."""
        self.bills.append(bill)

    @property
    def cumulative(self) -> list[int]:
        """Running total of billed tokens after each query."""
        out, run = [], 0
        for b in self.bills:
            run += b.total
            out.append(run)
        return out

    @property
    def total_billed(self) -> int:
        """Total billed tokens of the run."""
        return sum(b.total for b in self.bills)

    def summary(self) -> dict:
        """Per-query means and totals of the run."""
        n = max(len(self.bills), 1)
        return {
            "queries": len(self.bills),
            "total_billed": self.total_billed,
            "mean_billed": self.total_billed / n,
            "mean_prompt": sum(b.prompt_tokens for b in self.bills) / n,
            "mean_completion": sum(b.completion_tokens for b in self.bills) / n,
            "mean_embedding": sum(b.embedding_tokens for b in self.bills) / n,
            "index_embedding_tokens": self.index_embedding_tokens,
        }
