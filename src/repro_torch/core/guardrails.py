"""Operational guardrails (paper §VII.C, §VIII.B, §VIII.E).

The paper motivates three guardrails from its failure-mode analysis:

* **Low-confidence fallback** (§VII.C): when retrieval confidence is below a
  threshold the corpus likely lacks coverage — "low retrieval confidence
  could trigger a fallback to direct_llm rather than generating a
  poorly-grounded answer from low-quality context".
* **Max-context-token guardrail** (§VIII.B): cap injected context tokens so
  no query incurs a catastrophic cost overrun.
* **Cost ceiling** (§VIII.D adjacent): hard per-query billed-token budget —
  demote to the deepest bundle whose cost prior fits.

These post-process routing decisions / retrieval outputs; they never modify
the utility function itself, keeping the routing math auditable.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

from repro_torch.core.bundles import BundleCatalog


@dataclasses.dataclass(frozen=True)
class GuardrailConfig:
    """Thresholds of the confidence, context and cost guardrails."""
    min_retrieval_confidence: float = 0.0  # 0 disables the fallback
    max_context_tokens: int | None = None
    max_cost_tokens: int | None = None
    fallback_bundle: str = "direct_llm"
    # Per-backend low-confidence thresholds, overriding the global value for
    # bundles routed through that backend. Confidence *units differ per
    # backend* (cosine for dense/IVF/hybrid, raw unbounded BM25 for bm25 —
    # docs/retrieval.md#caveats), so one global threshold cannot be
    # meaningful across a mixed-backend catalog: set e.g.
    # ``{"bm25": 2.5}`` to guard lexical bundles on their own scale. An
    # entry of 0.0 disables the guardrail for that backend.
    min_retrieval_confidence_by_backend: Mapping[str, float] | None = None


@dataclasses.dataclass(frozen=True)
class GuardrailOutcome:
    """A guardrail's verdict: the bundle to use and why it changed."""
    bundle_index: int
    demoted: bool
    reason: str | None


class Guardrails:
    """Pre-execution cost ceiling and post-retrieval confidence fallback."""
    def __init__(self, catalog: BundleCatalog, config: GuardrailConfig = GuardrailConfig()):
        self.catalog = catalog
        self.config = config
        self._fallback_idx = catalog.index_of(config.fallback_bundle)

    def pre_execution(self, bundle_index: int) -> GuardrailOutcome:
        """Cost-ceiling demotion before any tokens are spent."""
        cfg = self.config
        if cfg.max_cost_tokens is not None:
            b = self.catalog[bundle_index]
            if b.cost_prior_tokens > cfg.max_cost_tokens:
                # Demote to the deepest bundle whose cost prior fits.
                best, best_k = None, -1
                for i, cand in enumerate(self.catalog):
                    if cand.cost_prior_tokens <= cfg.max_cost_tokens and cand.top_k > best_k:
                        best, best_k = i, cand.top_k
                if best is None:
                    best = self._fallback_idx
                if best != bundle_index:
                    return GuardrailOutcome(best, True, "cost_ceiling")
        return GuardrailOutcome(bundle_index, False, None)

    def confidence_threshold(self, backend: str) -> float:
        """The low-confidence threshold for bundles on ``backend`` — the
        per-backend override when configured, the global value otherwise."""
        by_backend = self.config.min_retrieval_confidence_by_backend
        if by_backend is not None and backend in by_backend:
            return float(by_backend[backend])
        return self.config.min_retrieval_confidence

    def post_retrieval(
        self, bundle_index: int, retrieval_confidence: float
    ) -> GuardrailOutcome:
        """Low-confidence fallback after retrieval, before generation.

        The threshold is resolved per backend (see
        :meth:`confidence_threshold`): retrieval confidence is the top hit's
        score, whose scale is backend-specific, so a mixed-backend catalog
        guards each backend on its own scale.
        """
        cfg = self.config
        b = self.catalog[bundle_index]
        threshold = self.confidence_threshold(b.backend)
        if (
            not b.skip_retrieval
            and threshold > 0.0
            and retrieval_confidence < threshold
        ):
            return GuardrailOutcome(self._fallback_idx, True, "low_retrieval_confidence")
        return GuardrailOutcome(bundle_index, False, None)

    def clamp_context(self, context_token_count: int) -> int:
        """Max-context guardrail: how many context tokens may be injected."""
        if self.config.max_context_tokens is None:
            return context_token_count
        return min(context_token_count, self.config.max_context_tokens)
