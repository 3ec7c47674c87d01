"""Passage segmentation (paper §V.E: "segments documents into line-level
passages"), plus the sliding-window chunker a larger corpus needs (§VIII.F
"chunking policy effects")."""

from __future__ import annotations

import dataclasses
from typing import Iterable

from repro_torch.retrieval.tokenizer import count_tokens, words


@dataclasses.dataclass(frozen=True)
class Passage:
    """One retrievable passage: id, text and source document id."""
    passage_id: int
    text: str
    doc_id: int = 0

    @property
    def token_count(self) -> int:
        """Billing tokens of the passage text."""
        return count_tokens(self.text)


def line_passages(document: str, doc_id: int = 0, *, start_id: int = 0) -> list[Passage]:
    """The paper's chunker: one passage per non-empty line."""
    out = []
    pid = start_id
    for line in document.splitlines():
        line = line.strip()
        if not line:
            continue
        out.append(Passage(pid, line, doc_id))
        pid += 1
    return out


def sliding_window_passages(
    document: str,
    doc_id: int = 0,
    *,
    window_words: int = 64,
    stride_words: int = 48,
    start_id: int = 0,
) -> list[Passage]:
    """Word-window chunking for corpora without line structure."""
    if window_words <= 0 or stride_words <= 0:
        raise ValueError("window_words and stride_words must be positive")
    ws = document.split()
    if not ws:
        return []
    out, pid, i = [], start_id, 0
    while True:
        chunk = " ".join(ws[i : i + window_words])
        out.append(Passage(pid, chunk, doc_id))
        pid += 1
        if i + window_words >= len(ws):
            break
        i += stride_words
    return out


def corpus_passages(documents: Iterable[str], *, mode: str = "line", **kwargs) -> list[Passage]:
    """Chunk a document collection with globally unique passage ids."""
    chunker = {"line": line_passages, "window": sliding_window_passages}[mode]
    out: list[Passage] = []
    for doc_id, doc in enumerate(documents):
        out.extend(chunker(doc, doc_id, start_id=len(out), **kwargs))
    return out
