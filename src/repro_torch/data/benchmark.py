"""The paper's benchmark artifacts, verbatim (Appendices D and E).

* ``BENCHMARK_CORPUS`` — the 15-sentence technical corpus (§VI.A, App. E).
* ``BENCHMARK_QUERIES`` — the 28 natural-language queries (App. D).
* ``PAPER_ASSIGNMENTS`` — the paper's per-query strategy assignments
  (App. G), used as a reproduction target.
* ``REFERENCE_ANSWERS`` — references for the lexical quality proxy. The
  paper does not publish its references; ours are the corpus sentences most
  relevant to each query (for in-corpus topics) or a concise canonical
  answer (for out-of-corpus topics), which reproduces the paper's coverage-
  gap phenomenon (§VIII.E: queries about concepts absent from the corpus
  score low on the lexical proxy).
"""

from __future__ import annotations

BENCHMARK_CORPUS: tuple[str, ...] = (
    "RAG improves LLM accuracy by retrieving relevant documents before generation.",
    "Token cost is a major concern because embedding and completion APIs bill per token.",
    "Latency depends on retrieval time, reranking, and model inference time under load.",
    "Adaptive systems dynamically select strategies based on query complexity and observed telemetry.",
    "Cost-aware AI systems optimize resource usage while maintaining answer quality under SLO constraints.",
    "Hybrid dense-sparse retrieval combines embedding similarity with BM25 lexical overlap for robustness.",
    "Utility-based routing scores each strategy bundle using quality priors minus latency and cost penalties.",
    "Municipal RAG applications ground answers in ordinances, forms, and public documents with provenance.",
    "Production RAG should expose retrieval confidence and source citations for auditability and trust.",
    "Embedding indexes such as FAISS enable approximate nearest neighbor search over chunked corpora.",
    "Strategy bundles pair retrieval depth with generation budgets to trade accuracy against spend.",
    "Telemetry can refine latency and quality estimates per bundle after sufficient query volume.",
    "Skipping retrieval reduces cost for definitional queries but risks hallucination on fact-heavy tasks.",
    "Large top-k retrieval increases recall but inflates prompt tokens and end-to-end latency.",
    "Reranking stages reorder candidates using cross-encoders at extra compute cost.",
)

BENCHMARK_QUERIES: tuple[str, ...] = (
    "What is RAG?",
    "Why is token cost important?",
    "How does latency affect AI systems?",
    "What is adaptive retrieval?",
    "Explain cost-aware AI systems.",
    "What is hybrid retrieval?",
    "Define utility-based routing.",
    "What is FAISS used for?",
    "How do strategy bundles work in CA-RAG?",
    "What is retrieval confidence?",
    "Compare light versus heavy retrieval for long documents.",
    "Explain how telemetry refines routing estimates with concrete steps.",
    "Why might a system skip retrieval for some queries?",
    "List tradeoffs between large top-k and small top-k retrieval.",
    "How do embedding tokens differ from completion tokens in billing?",
    "Describe a municipal RAG use case with forms and citations.",
    "What are the risks of fixed retrieval depth across heterogeneous queries?",
    "How does CA-RAG combine quality, latency, and cost in one scalar objective?",
    "Explain when reranking is worth the extra latency in production.",
    "Derive an intuitive explanation of why discrete bundles are used instead of continuous search.",
    "What operational metrics should a team report for a deployed RAG service?",
    "How does query length influence estimated complexity signals in CA-RAG?",
    "Contrast direct LLM answers with retrieval-grounded answers for policy questions.",
    "What limitations apply to lexical quality proxies versus human evaluation?",
    "How would you tune utility weights for a latency-sensitive chatbot?",
    "Describe an experiment protocol to log strategy choices and token usage per query.",
    "What is the role of exploration epsilon in bundle selection?",
    "Explain retrieval-augmented generation for knowledge-intensive tasks in two sentences.",
)

# Appendix G: the paper's routed strategy per query (reproduction target).
PAPER_ASSIGNMENTS: tuple[str, ...] = (
    "direct_llm",
    "direct_llm",
    "light_rag",
    "light_rag",
    "medium_rag",
    "medium_rag",
    "medium_rag",
    "heavy_rag",
    "heavy_rag",
    "medium_rag",
    "medium_rag",
    "light_rag",
    "heavy_rag",
    "medium_rag",
    "medium_rag",
    "medium_rag",
    "medium_rag",
    "heavy_rag",
    "medium_rag",
    "direct_llm",
    "heavy_rag",
    "medium_rag",
    "medium_rag",
    "medium_rag",
    "medium_rag",
    "medium_rag",
    "light_rag",
    "medium_rag",
)

# Index of the corpus line(s) most relevant per query; -1 = out-of-corpus
# (coverage gap). Used to build lexical-proxy references.
_QUERY_SUPPORT: tuple[tuple[int, ...], ...] = (
    (0,),  # What is RAG?
    (1,),  # token cost
    (2,),  # latency
    (3,),  # adaptive retrieval
    (4,),  # cost-aware systems
    (5,),  # hybrid retrieval
    (6,),  # utility-based routing
    (9,),  # FAISS
    (10,),  # strategy bundles
    (8,),  # retrieval confidence
    (13, 2),  # light vs heavy for long documents
    (11,),  # telemetry refinement
    (12,),  # skip retrieval
    (13,),  # top-k tradeoffs
    (1,),  # embedding vs completion tokens
    (7,),  # municipal
    (12, 13),  # fixed-depth risks
    (6,),  # scalar objective
    (14,),  # reranking
    (10, 6),  # discrete bundles rationale
    (8, 11),  # operational metrics
    (3,),  # query length / complexity
    (0, 12),  # direct vs grounded
    (-1,),  # lexical proxies vs human eval — coverage gap
    (6, 4),  # tuning weights for latency-sensitive chat
    (11, 8),  # experiment protocol
    (-1,),  # exploration epsilon — coverage gap
    (0,),  # RAG in two sentences
)

# Canonical references for out-of-corpus queries (coverage gaps): a short
# plausible expert answer — the router is "unfairly penalized" on these just
# as in the paper (§VIII.E).
_GAP_REFERENCES: dict[int, str] = {
    23: "Lexical quality proxies measure surface token overlap and miss semantic "
    "accuracy, factual correctness, and user satisfaction that human evaluation captures.",
    26: "Exploration epsilon occasionally selects a non-greedy bundle so the router "
    "keeps gathering telemetry about alternatives instead of exploiting stale priors.",
}


def reference_answer(query_index: int) -> str:
    """Reference text for the lexical quality proxy of query i."""
    support = _QUERY_SUPPORT[query_index]
    if support[0] == -1:
        return _GAP_REFERENCES[query_index]
    return " ".join(BENCHMARK_CORPUS[j] for j in support)


REFERENCE_ANSWERS: tuple[str, ...] = tuple(
    reference_answer(i) for i in range(len(BENCHMARK_QUERIES))
)


def corpus_document() -> str:
    """The benchmark corpus as one newline-separated document (the paper's
    ``data/documents_benchmark.txt``)."""
    return "\n".join(BENCHMARK_CORPUS)


def is_coverage_gap(query_index: int) -> bool:
    """Whether query ``query_index`` asks about a topic the corpus lacks."""
    return _QUERY_SUPPORT[query_index][0] == -1
