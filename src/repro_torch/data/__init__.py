"""Benchmark data: the paper's Appendix D/E artifacts."""
from repro_torch.data.benchmark import (
    BENCHMARK_CORPUS,
    BENCHMARK_QUERIES,
    PAPER_ASSIGNMENTS,
    REFERENCE_ANSWERS,
    corpus_document,
    is_coverage_gap,
    reference_answer,
)

__all__ = [
    "BENCHMARK_CORPUS", "BENCHMARK_QUERIES", "PAPER_ASSIGNMENTS",
    "REFERENCE_ANSWERS", "corpus_document", "is_coverage_gap", "reference_answer",
]
