"""Carry state from the JAX package into the port, through numpy.

This slice runs no model; its state is the corpus embeddings (and the
catalog's prior arrays). Later slices add the transformer's parameters here.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.retrieval.chunking import Passage
from repro_torch.retrieval.index import DenseIndex


def index_from_numpy(
    embeddings: np.ndarray,
    passages: Sequence[Passage] | None = None,
    *,
    device: str | torch.device = "cuda",
) -> DenseIndex:
    """Install already-normalized rows (e.g. ``np.asarray`` of a JAX
    ``DenseIndex.embeddings``) bit for bit, without re-normalizing."""
    # a copy: arrays taken from JAX are read-only views
    emb = np.array(embeddings, dtype=np.float32, copy=True)
    return DenseIndex(emb, passages, assume_normalized=True, device=device)


def catalog_from_jax_arrays(
    arrays: Mapping[str, np.ndarray], *, device: str | torch.device
) -> dict[str, torch.Tensor]:
    """Tensors of a JAX ``BundleCatalog.as_arrays()`` dict (via ``np.asarray``),
    with their dtypes kept."""
    device = resolve_device(device)
    return {k: torch.from_numpy(np.array(v)).to(device) for k, v in arrays.items()}
