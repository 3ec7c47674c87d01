"""Answer generation behind one interface.

* :class:`ExtractiveGenerator` — the deterministic offline stand-in for the
  paper's gpt-3.5 call. Grounded bundles synthesize an answer from the
  retrieved passages; direct (retrieval-free) answers draw on a *parametric
  knowledge table* — the same technical facts the corpus encodes, compiled
  into the generator, which is exactly the premise of the paper's
  direct_llm bundle ("parametric LLM knowledge is sufficient" for
  definitional queries, §VII.A). Direct answers are deliberately more
  verbose and more length-variable than grounded ones (the §VII.B
  mechanism behind direct_llm's latency variance).

Port of ``repro.serving.generator``. ``LMGenerator`` and
``TransformerSlotDecoder`` wait for the decode slice.
"""

from __future__ import annotations

import dataclasses
from typing import Protocol, Sequence

from repro_torch.core.bundles import GenerationSpec
from repro_torch.data.benchmark import BENCHMARK_CORPUS
from repro_torch.retrieval.tokenizer import count_tokens, terms, words


class Generator(Protocol):
    """Anything that answers a query from context passages."""

    def generate(
        self, query: str, context_passages: Sequence[str], spec: GenerationSpec, *, query_id: int = 0
    ) -> str:
        """Answer ``query`` from ``context_passages`` under ``spec``."""
        ...


def _truncate_to_tokens(text: str, max_tokens: int) -> str:
    if count_tokens(text) <= max_tokens:
        return text
    ws = text.split()
    lo, hi = 0, len(ws)
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if count_tokens(" ".join(ws[:mid])) <= max_tokens:
            lo = mid
        else:
            hi = mid - 1
    return " ".join(ws[:lo])


@dataclasses.dataclass(frozen=True)
class ExtractiveGeneratorConfig:
    """Templates and verbosity budgets of the extractive generator."""
    grounded_preamble: str = "Based on the retrieved context:"
    grounded_closing: str = (
        "Together these sources answer the question directly and can be cited as given."
    )
    grounded_max_passages_quoted: int = 3
    lexical_rerank: bool = True  # rerank retrieved k by term overlap pre-quote
    direct_preambles: tuple[str, ...] = (
        "Speaking from general knowledge,",
        "In broad terms, and considering common practice across production systems,",
        "To answer directly without consulting any external sources,",
    )
    # direct answers are long and length-variable (paper §VII.B); token budgets
    # selected by query hash:
    direct_verbosity_tokens: tuple[int, ...] = (40, 90, 150)
    # grounded answers elaborate by a small query-dependent amount (dilutes
    # the complexity→cost correlation toward the paper's weak r≈0.22):
    grounded_verbosity_tokens: tuple[int, ...] = (0, 13, 26)


class ExtractiveGenerator:
    """Deterministic template generator with a parametric knowledge table."""

    def __init__(self, config: ExtractiveGeneratorConfig = ExtractiveGeneratorConfig(),
                 knowledge: Sequence[str] = BENCHMARK_CORPUS):
        self.config = config
        self.knowledge = list(knowledge)
        self._knowledge_terms = [set(terms(k, remove_stopwords=True)) for k in self.knowledge]
        # passage text → term set; passages repeat across queries (the corpus
        # is fixed), so the serving hot path skips re-tokenizing them
        self._passage_terms: dict[str, set[str]] = {}

    def _terms_of(self, passage: str) -> set[str]:
        cached = self._passage_terms.get(passage)
        if cached is None:
            cached = set(terms(passage, remove_stopwords=True))
            self._passage_terms[passage] = cached
        return cached

    # -- parametric recall ------------------------------------------------------
    def _recall(self, query: str, n: int = 2) -> list[str]:
        q = set(terms(query, remove_stopwords=True))
        scored = [
            (len(q & kt) / max(len(kt), 1), i) for i, kt in enumerate(self._knowledge_terms)
        ]
        scored.sort(key=lambda t: (-t[0], t[1]))
        return [self.knowledge[i] for s, i in scored[:n] if s > 0]

    def _rerank(self, query: str, passages: Sequence[str]) -> list[tuple[int, str]]:
        """Cheap lexical reranker over the retrieved candidates (§VIII.E's
        'reranking bundles' mitigation, applied inside generation). Returns
        (overlap_score, passage) pairs, best first."""
        q = set(terms(query, remove_stopwords=True))
        scored = sorted(
            ((len(q & self._terms_of(p)), -i, p) for i, p in enumerate(passages)),
            reverse=True,
        )
        return [(s, p) for s, _, p in scored]

    def generate(self, query, context_passages, spec, *, query_id: int = 0):
        """Answer ``query`` from ``context_passages`` under ``spec``."""
        if context_passages:
            if self.config.lexical_rerank:
                ranked = self._rerank(query, context_passages)
                # adaptive quoting: cite every passage that actually bears on
                # the question (positive term overlap), at least one, at most
                # grounded_max_passages_quoted — so completion length varies
                # per query, not per bundle
                quoted = [p for s, p in ranked if s > 0][: self.config.grounded_max_passages_quoted]
                if not quoted:
                    quoted = [ranked[0][1]]
            else:
                quoted = list(context_passages)[: self.config.grounded_max_passages_quoted]
            body = " ".join(quoted)
            extra_tokens = self.config.grounded_verbosity_tokens[
                (query_id * 2654435761) % len(self.config.grounded_verbosity_tokens)
            ]
            elaboration = " ".join(
                ["In practice the cited guidance holds across deployments of varying scale,"]
                * max(0, extra_tokens // 13)
            )
            answer = f"{self.config.grounded_preamble} {body} {elaboration} {self.config.grounded_closing}"
        else:
            recall = self._recall(query, n=2)
            h = query_id % len(self.config.direct_preambles)
            pre = self.config.direct_preambles[h]
            filler_tokens = self.config.direct_verbosity_tokens[
                (query_id * 2654435761) % len(self.config.direct_verbosity_tokens)
            ]
            filler = " ".join(
                ["considering typical deployments, pricing models, and the operational "
                 "tradeoffs teams encounter when tuning such systems in practice,"]
                * max(1, filler_tokens // 20)
            )
            body = " ".join(recall) if recall else (
                "this depends on system specifics and should be validated empirically."
            )
            answer = (
                f"{pre} {body} More broadly, {filler} so the details vary by workload "
                "and should be monitored continuously over time."
            )
        return _truncate_to_tokens(answer, spec.max_output_tokens)


def build_prompt(query: str, context_passages: Sequence[str]) -> str:
    """The engine's prompt template (token-accounted by billing.py).

    Retrieval bundles inject citation-tagged passages (the per-passage
    overhead that makes heavy_rag's prompt cost scale with k, Fig. 5).
    """
    if not context_passages:
        return (
            "You are a helpful assistant. Answer from your own knowledge.\n"
            f"Question: {query}\nAnswer:"
        )
    cited = "\n".join(f"[{i + 1}] {p}" for i, p in enumerate(context_passages))
    return (
        "You are a helpful assistant. Ground your answer strictly in the numbered "
        "sources below, cite them inline as [n], and do not speculate beyond them. "
        "If the sources do not cover the question, say so explicitly.\n"
        f"{cited}\nQuestion: {query}\nAnswer:"
    )
