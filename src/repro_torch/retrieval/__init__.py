"""Retrieval substrate (port of ``repro.retrieval``): tokenization, chunking,
embedding, the dense MIPS index and its backend adapter."""

from repro_torch.retrieval.backend import (
    BackendCost,
    DEFAULT_BACKEND_COSTS,
    DenseBackend,
    RetrievalBackend,
    backend_cost,
    make_backends,
)
from repro_torch.retrieval.chunking import (
    Passage,
    corpus_passages,
    line_passages,
    sliding_window_passages,
)
from repro_torch.retrieval.embedder import CachingEmbedder, HashedNGramEmbedder
from repro_torch.retrieval.index import DenseIndex, SearchResult, l2_normalize
from repro_torch.retrieval.synthetic import synthetic_dense_index
from repro_torch.retrieval.tokenizer import count_tokens, lexical_overlap, terms, words
from repro_torch.retrieval.topk import blocked_topk, merge_topk

__all__ = [
    "BackendCost", "DEFAULT_BACKEND_COSTS", "DenseBackend", "RetrievalBackend",
    "backend_cost", "make_backends", "Passage", "corpus_passages", "line_passages",
    "sliding_window_passages", "CachingEmbedder", "HashedNGramEmbedder",
    "DenseIndex", "SearchResult", "l2_normalize", "synthetic_dense_index",
    "count_tokens", "lexical_overlap", "terms", "words", "blocked_topk", "merge_topk",
]
