"""Strategy bundle catalog (paper §V.B, Table I) — port of ``repro.core.bundles``.

The four paper bundles::

    bundle      k   skip  qual.prior  lat.prior(ms)
    direct_llm  0   yes   0.52        8
    light_rag   3   no    0.66        45
    medium_rag  5   no    0.74        60
    heavy_rag   10  no    0.82        95

:meth:`BundleCatalog.as_arrays` returns torch tensors (float32 where the JAX
package uses float32) so utility evaluation vectorizes over
(queries × bundles).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Mapping, Sequence

import torch


@dataclasses.dataclass(frozen=True)
class GenerationSpec:
    """Fixed generation profile shared by all paper bundles (§V.B)."""

    max_output_tokens: int = 256
    temperature: float = 0.0
    name: str = "paper_gen"


@dataclasses.dataclass(frozen=True)
class Bundle:
    """One retrieval+generation strategy bundle (see ``repro.core.bundles.Bundle``)."""

    name: str
    top_k: int
    skip_retrieval: bool
    quality_prior: float
    latency_prior_ms: float
    cost_prior_tokens: float
    generation: GenerationSpec = GenerationSpec()
    depth_affinity: float = 0.0
    backend: str = "dense"

    def __post_init__(self):
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {self.top_k}")
        if self.skip_retrieval and self.top_k != 0:
            raise ValueError(f"skip_retrieval bundles must have top_k=0 ({self.name})")
        if not self.skip_retrieval and self.top_k == 0:
            raise ValueError(f"retrieval bundles must have top_k>0 ({self.name})")
        if not (0.0 <= self.quality_prior <= 1.0):
            raise ValueError(f"quality_prior must be in [0,1] ({self.name})")
        if not self.backend:
            raise ValueError(f"backend must be a non-empty name ({self.name})")

    @property
    def backend_cost(self):
        """Static cost descriptor of this bundle's retrieval backend."""
        from repro_torch.retrieval.backend import backend_cost  # lazy: no core→retrieval cycle

        return backend_cost(self.backend)

    @property
    def effective_latency_prior_ms(self) -> float:
        """Latency prior scaled by the backend's retrieve-stage cost."""
        return self.latency_prior_ms * self.backend_cost.latency_scale

    @property
    def effective_quality_prior(self) -> float:
        """Quality prior discounted by the backend's expected recall@k."""
        return self.quality_prior * self.backend_cost.recall_prior


def _paper_bundles() -> tuple[Bundle, ...]:
    """Table I, verbatim, plus cost priors (expected billed tokens)."""
    gen = GenerationSpec()
    return (
        Bundle("direct_llm", 0, True, 0.52, 8.0, 190.0, gen, -1.0),
        Bundle("light_rag", 3, False, 0.66, 45.0, 215.0, gen, -0.45),
        Bundle("medium_rag", 5, False, 0.74, 60.0, 275.0, gen, 1.0 / 3.0),
        Bundle("heavy_rag", 10, False, 0.82, 95.0, 360.0, gen, 1.0),
    )


class BundleCatalog:
    """An ordered, immutable catalog of bundles with tensor views."""

    def __init__(self, bundles: Sequence[Bundle] | None = None):
        bundles = tuple(bundles) if bundles is not None else _paper_bundles()
        if len(bundles) == 0:
            raise ValueError("catalog must contain at least one bundle")
        names = [b.name for b in bundles]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate bundle names: {names}")
        self._bundles = bundles
        self._index = {b.name: i for i, b in enumerate(bundles)}

    def __len__(self) -> int:
        return len(self._bundles)

    def __iter__(self) -> Iterator[Bundle]:
        return iter(self._bundles)

    def __getitem__(self, key: int | str) -> Bundle:
        if isinstance(key, str):
            return self._bundles[self._index[key]]
        return self._bundles[key]

    def index_of(self, name: str) -> int:
        """Catalog position of the bundle named ``name``."""
        return self._index[name]

    @property
    def names(self) -> tuple[str, ...]:
        """Bundle names, catalog order."""
        return tuple(b.name for b in self._bundles)

    @property
    def backend_names(self) -> tuple[str, ...]:
        """Per-bundle backend name, catalog order."""
        return tuple(b.backend for b in self._bundles)

    def backends_used(self) -> tuple[str, ...]:
        """Unique backends any retrieval bundle routes through (first-use order)."""
        return tuple(
            dict.fromkeys(b.backend for b in self._bundles if not b.skip_retrieval)
        )

    def routed_by_backend(self, strategy_counts: Mapping[str, int]) -> dict[str, int]:
        """Aggregate per-bundle routed counts by retrieval backend (sorted keys)."""
        out: dict[str, int] = {}
        for name, n in strategy_counts.items():
            b = self[name]
            key = "no_retrieval" if b.skip_retrieval else b.backend
            out[key] = out.get(key, 0) + n
        return dict(sorted(out.items()))

    def as_arrays(self, device: str | torch.device = "cpu") -> Mapping[str, torch.Tensor]:
        """Catalog priors as a dict of ``(n_bundles,)`` tensors on ``device``.

        Same keys and dtypes as ``repro.core.bundles.BundleCatalog.as_arrays``.
        """
        b = self._bundles
        f32 = dict(dtype=torch.float32, device=device)
        return {
            "quality_prior": torch.tensor([x.quality_prior for x in b], **f32),
            "latency_prior_ms": torch.tensor(
                [x.effective_latency_prior_ms for x in b], **f32
            ),
            "cost_prior_tokens": torch.tensor([x.cost_prior_tokens for x in b], **f32),
            "top_k": torch.tensor([x.top_k for x in b], dtype=torch.int32, device=device),
            "skip_retrieval": torch.tensor(
                [x.skip_retrieval for x in b], dtype=torch.bool, device=device
            ),
            "depth_affinity": torch.tensor([x.depth_affinity for x in b], **f32),
            "backend_recall": torch.tensor([x.backend_cost.recall_prior for x in b], **f32),
            "backend_latency_scale": torch.tensor(
                [x.backend_cost.latency_scale for x in b], **f32
            ),
        }

    def with_bundle(self, bundle: Bundle) -> "BundleCatalog":
        """Catalog with one more bundle appended."""
        return BundleCatalog(self._bundles + (bundle,))

    def __repr__(self) -> str:
        return f"BundleCatalog({', '.join(self.names)})"


CATALOG_PRESETS: tuple[str, ...] = ("paper", "extended")


def make_catalog(preset: str = "paper") -> BundleCatalog:
    """Catalog presets. Only ``paper`` (Table I, dense-only) is ported; the
    ``extended`` catalog needs the BM25/IVF/hybrid backends of a later slice."""
    if preset == "paper":
        return BundleCatalog()
    if preset == "extended":
        raise NotImplementedError("the extended catalog is not ported yet")
    raise ValueError(f"unknown catalog preset {preset!r}; expected one of {CATALOG_PRESETS}")


DEFAULT_CATALOG = BundleCatalog()
