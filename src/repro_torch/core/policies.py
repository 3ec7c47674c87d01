"""The paper's seven evaluation policies (§VI.C) as a registry.

(i)   router_default            — weights (0.6, 0.2, 0.2)
(ii)  router_latency_sensitive  — w_L = 0.5
(iii) router_cost_sensitive     — w_C = 0.5
(iv)  fixed_direct / fixed_light / fixed_medium / fixed_heavy
"""

from __future__ import annotations

from typing import Callable

from repro_torch.core.bundles import BundleCatalog, DEFAULT_CATALOG
from repro_torch.core.router import FixedRouter, Router, RouterConfig
from repro_torch.core.utility import (
    COST_SENSITIVE_WEIGHTS,
    DEFAULT_WEIGHTS,
    LATENCY_SENSITIVE_WEIGHTS,
)

PolicyFactory = Callable[[BundleCatalog, RouterConfig], Router]


def _router_with(weights) -> PolicyFactory:
    def make(catalog: BundleCatalog, config: RouterConfig) -> Router:
        import dataclasses

        return Router(catalog, dataclasses.replace(config, weights=weights))

    return make


def _fixed(bundle_name: str) -> PolicyFactory:
    def make(catalog: BundleCatalog, config: RouterConfig) -> Router:
        return FixedRouter(bundle_name, catalog, config)

    return make


POLICIES: dict[str, PolicyFactory] = {
    "router_default": _router_with(DEFAULT_WEIGHTS),
    "router_latency_sensitive": _router_with(LATENCY_SENSITIVE_WEIGHTS),
    "router_cost_sensitive": _router_with(COST_SENSITIVE_WEIGHTS),
    "fixed_direct": _fixed("direct_llm"),
    "fixed_light": _fixed("light_rag"),
    "fixed_medium": _fixed("medium_rag"),
    "fixed_heavy": _fixed("heavy_rag"),
}


def make_policy(
    name: str,
    catalog: BundleCatalog = DEFAULT_CATALOG,
    config: RouterConfig = RouterConfig(),
) -> Router:
    """Router of the named paper policy over ``catalog``."""
    if name not in POLICIES:
        raise KeyError(f"unknown policy {name!r}; available: {sorted(POLICIES)}")
    return POLICIES[name](catalog, config)
