"""Per-query bundle selection (paper §IV, Appendix A) — port of ``repro.core.router``.

``b* = argmax_b U_b(q)``. Two call paths, as in the JAX package:

* :meth:`Router.route_batch_arrays` — torch over a complexity tensor, on
  that tensor's device.
* :meth:`Router.route_batch_np` — the numpy mirror the serving replay uses.

Both take the lowest bundle index on a utility tie (``torch.argmax`` and
``np.argmax`` return the first maximum, as ``jnp.argmax`` does).
ε-greedy exploration (``RouterConfig.epsilon > 0``) is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import numpy as np
import torch

from repro_torch.core.bundles import Bundle, BundleCatalog, DEFAULT_CATALOG
from repro_torch.core.signals import (
    DEFAULT_ALPHA,
    DEFAULT_BETA,
    DEFAULT_K_MAX,
    DEFAULT_L_MAX,
    batch_complexity,
    extract_signal_matrix,
)
from repro_torch.core.utility import (
    DEFAULT_C0,
    DEFAULT_C1,
    DEFAULT_DELTA,
    DEFAULT_GAMMA,
    DEFAULT_GLOBAL_DECAY,
    DEFAULT_WEIGHTS,
    UtilityWeights,
    selection_utilities,
    selection_utilities_np,
)


@dataclasses.dataclass(frozen=True)
class RoutingDecision:
    """Auditable per-query routing record (paper §IV.A)."""

    query: str
    bundle: Bundle
    bundle_index: int
    complexity: float
    utilities: Mapping[str, float]  # bundle name → U_b
    explored: bool = False

    @property
    def selection_utility(self) -> float:
        """Utility of the chosen bundle."""
        return self.utilities[self.bundle.name]


@dataclasses.dataclass(frozen=True)
class RouterConfig:
    """All scalar knobs of the routing layer in one place."""

    weights: UtilityWeights = DEFAULT_WEIGHTS
    gamma: float = DEFAULT_GAMMA
    c0: float = DEFAULT_C0
    delta: float = DEFAULT_DELTA
    c1: float = DEFAULT_C1
    global_decay: float = DEFAULT_GLOBAL_DECAY
    alpha: float = DEFAULT_ALPHA
    beta: float = DEFAULT_BETA
    l_max: float = DEFAULT_L_MAX
    k_max: float = DEFAULT_K_MAX
    epsilon: float = 0.0  # exploration; 0 in the paper's benchmark


class Router:
    """Discrete utility-maximizing router over a bundle catalog."""

    def __init__(
        self,
        catalog: BundleCatalog = DEFAULT_CATALOG,
        config: RouterConfig = RouterConfig(),
    ):
        if config.epsilon > 0.0:
            raise NotImplementedError("epsilon > 0 exploration is not ported yet")
        self.catalog = catalog
        self.config = config
        self._arrays = catalog.as_arrays()
        self._arrays_np = {k: v.numpy() for k, v in self._arrays.items()}

    def complexity_batch(self, queries: Sequence[str]) -> torch.Tensor:
        """Signals → complexity ``(N,)`` float32 (host tensor)."""
        sig = extract_signal_matrix(queries)
        return batch_complexity(
            sig,
            alpha=self.config.alpha,
            beta=self.config.beta,
            l_max=self.config.l_max,
            k_max=self.config.k_max,
        )

    def utilities_from_complexity(
        self,
        complexity: torch.Tensor,
        *,
        latency_override=None,
        cost_override=None,
        recall_override=None,
    ) -> torch.Tensor:
        """Eq. 1 utilities ``(N, B)`` from a complexity vector ``(N,)``."""
        return selection_utilities(
            self._arrays,
            complexity,
            weights=self.config.weights,
            gamma=self.config.gamma,
            c0=self.config.c0,
            delta=self.config.delta,
            c1=self.config.c1,
            global_decay=self.config.global_decay,
            latency_override=latency_override,
            cost_override=cost_override,
            recall_override=recall_override,
        )

    def route_batch_arrays(
        self,
        complexity: torch.Tensor,
        *,
        latency_override=None,
        cost_override=None,
        recall_override=None,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Route a complexity batch → (bundle_idx ``(N,)`` int32, U ``(N, B)``)."""
        utilities = self.utilities_from_complexity(
            complexity,
            latency_override=latency_override,
            cost_override=cost_override,
            recall_override=recall_override,
        )
        return torch.argmax(utilities, dim=-1).to(torch.int32), utilities

    def route_batch_np(
        self,
        complexity: np.ndarray,
        *,
        latency_override: np.ndarray | None = None,
        cost_override: np.ndarray | None = None,
        recall_override: np.ndarray | None = None,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Host mirror of :meth:`route_batch_arrays` (numpy, greedy)."""
        utilities = self._utilities_np(
            complexity,
            latency_override=latency_override,
            cost_override=cost_override,
            recall_override=recall_override,
        )
        return utilities.argmax(axis=-1).astype(np.int32), utilities

    def _utilities_np(
        self,
        complexity: np.ndarray,
        *,
        latency_override: np.ndarray | None = None,
        cost_override: np.ndarray | None = None,
        recall_override: np.ndarray | None = None,
    ) -> np.ndarray:
        return selection_utilities_np(
            self._arrays_np,
            complexity,
            weights=self.config.weights,
            gamma=self.config.gamma,
            c0=self.config.c0,
            delta=self.config.delta,
            c1=self.config.c1,
            global_decay=self.config.global_decay,
            latency_override=latency_override,
            cost_override=cost_override,
            recall_override=recall_override,
        )

    def route(
        self,
        queries: Sequence[str] | str,
        *,
        latency_override=None,
        cost_override=None,
        recall_override=None,
    ) -> list[RoutingDecision]:
        """Route query strings; returns full audit records."""
        single = isinstance(queries, str)
        qs: Sequence[str] = [queries] if single else list(queries)
        cplx = self.complexity_batch(qs)
        idx, utilities = self.route_batch_arrays(
            cplx,
            latency_override=latency_override,
            cost_override=cost_override,
            recall_override=recall_override,
        )
        idx_np = idx.cpu().numpy()
        util_np = utilities.cpu().numpy()
        cplx_np = cplx.cpu().numpy()
        return [
            RoutingDecision(
                query=q,
                bundle=self.catalog[int(idx_np[i])],
                bundle_index=int(idx_np[i]),
                complexity=float(cplx_np[i]),
                utilities={
                    name: float(util_np[i, j]) for j, name in enumerate(self.catalog.names)
                },
            )
            for i, q in enumerate(qs)
        ]

    def complexity_of(self, query: str) -> float:
        """Complexity of one query string."""
        return float(self.complexity_batch([query])[0])


class FixedRouter(Router):
    """Degenerate router: always selects one bundle (the fixed-* baselines,
    §VI.C). Utilities are still computed for telemetry parity."""

    def __init__(
        self,
        bundle_name: str,
        catalog: BundleCatalog = DEFAULT_CATALOG,
        config: RouterConfig = RouterConfig(),
    ):
        super().__init__(catalog, config)
        self.fixed_index = catalog.index_of(bundle_name)

    def route_batch_arrays(
        self, complexity, *, latency_override=None, cost_override=None, recall_override=None,
    ):
        """Always the fixed bundle; utilities are still computed."""
        utilities = self.utilities_from_complexity(
            complexity,
            latency_override=latency_override,
            cost_override=cost_override,
            recall_override=recall_override,
        )
        n = utilities.shape[0]
        return (
            torch.full((n,), self.fixed_index, dtype=torch.int32, device=utilities.device),
            utilities,
        )

    def route_batch_np(
        self, complexity, *, latency_override=None, cost_override=None, recall_override=None,
    ):
        """Numpy mirror of :meth:`route_batch_arrays`."""
        utilities = self._utilities_np(
            complexity,
            latency_override=latency_override,
            cost_override=cost_override,
            recall_override=recall_override,
        )
        n = utilities.shape[0]
        return np.full((n,), self.fixed_index, dtype=np.int32), utilities
