"""Query signals and heuristic complexity (paper §V.A) — port of ``repro.core.signals``.

``extract_signals`` is host string processing; ``complexity_from_signals`` /
``batch_complexity`` are vectorized torch float32::

    c(q) = clip(alpha * wordlen(q)/L_max + beta * cues(q)/K_max, 0, 1)
"""

from __future__ import annotations

import dataclasses
import re
from typing import Sequence

import numpy as np
import torch

CUE_WORDS: frozenset[str] = frozenset(
    {
        "what", "why", "how", "when", "where", "which", "who", "whom", "whose",
        "explain", "describe", "compare", "contrast", "list", "define", "derive",
    }
)

DEFAULT_ALPHA = 0.6
DEFAULT_BETA = 0.4
DEFAULT_L_MAX = 20.0
DEFAULT_K_MAX = 3.0

_WORD_RE = re.compile(r"[A-Za-z0-9']+")


@dataclasses.dataclass(frozen=True)
class QuerySignals:
    """Numeric per-query signals (paper §IV.A step 1)."""

    char_len: int
    word_count: int
    cue_count: int

    def as_row(self) -> np.ndarray:
        """The signals as a float32 row: char_len, word_count, cue_count."""
        return np.array([self.char_len, self.word_count, self.cue_count], dtype=np.float32)


def extract_signals(query: str) -> QuerySignals:
    """Host-side signal extraction for a single query string."""
    words = _WORD_RE.findall(query.lower())
    cues = sum(1 for w in words if w in CUE_WORDS)
    return QuerySignals(char_len=len(query), word_count=len(words), cue_count=cues)


def extract_signal_matrix(queries: Sequence[str]) -> np.ndarray:
    """Float32 ``(n, 3)`` matrix: char_len, word_count, cue_count."""
    if len(queries) == 0:
        return np.zeros((0, 3), dtype=np.float32)
    return np.stack([extract_signals(q).as_row() for q in queries])


def _div(x: torch.Tensor, d: float) -> torch.Tensor:
    # Divide by a full tensor, not a Python scalar: PyTorch may lower
    # tensor / scalar to tensor * (1/scalar), which rounds differently from
    # the IEEE division the JAX reference performs.
    return x / torch.full_like(x, d)


def complexity_from_signals(
    word_count,
    cue_count,
    *,
    alpha: float = DEFAULT_ALPHA,
    beta: float = DEFAULT_BETA,
    l_max: float = DEFAULT_L_MAX,
    k_max: float = DEFAULT_K_MAX,
) -> torch.Tensor:
    """Paper Eq. (§V.A): heuristic complexity in [0, 1], float32."""
    word_count = torch.as_tensor(word_count, dtype=torch.float32)
    cue_count = torch.as_tensor(cue_count, dtype=torch.float32)
    raw = _div(alpha * word_count, l_max) + _div(beta * cue_count, k_max)
    return torch.clamp(raw, 0.0, 1.0)


def batch_complexity(signal_matrix, **kwargs) -> torch.Tensor:
    """Complexity for an ``(n, 3)`` signal matrix (see extract_signal_matrix)."""
    sig = torch.as_tensor(np.asarray(signal_matrix, np.float32))
    return complexity_from_signals(sig[:, 1], sig[:, 2], **kwargs)


def complexity(query: str, **kwargs) -> float:
    """Convenience scalar path: string → c(q)."""
    s = extract_signals(query)
    return float(complexity_from_signals(float(s.word_count), float(s.cue_count), **kwargs))
