"""CA-RAG core (port of ``repro.core``): signals, bundles, utility, router,
telemetry, policies, guardrails."""

from repro_torch.core.bundles import Bundle, BundleCatalog, DEFAULT_CATALOG, GenerationSpec
from repro_torch.core.guardrails import GuardrailConfig, Guardrails
from repro_torch.core.policies import POLICIES, make_policy
from repro_torch.core.router import FixedRouter, Router, RouterConfig, RoutingDecision
from repro_torch.core.signals import QuerySignals, batch_complexity, complexity, extract_signals
from repro_torch.core.telemetry import QueryRecord, TelemetryStore
from repro_torch.core.utility import (
    COST_SENSITIVE_WEIGHTS,
    DEFAULT_WEIGHTS,
    LATENCY_SENSITIVE_WEIGHTS,
    RealizedNormalization,
    UtilityWeights,
    realized_utility,
    selection_utilities,
)

__all__ = [
    "Bundle", "BundleCatalog", "DEFAULT_CATALOG", "GenerationSpec",
    "GuardrailConfig", "Guardrails", "POLICIES", "make_policy",
    "FixedRouter", "Router", "RouterConfig", "RoutingDecision",
    "QuerySignals", "batch_complexity", "complexity", "extract_signals",
    "QueryRecord", "TelemetryStore",
    "COST_SENSITIVE_WEIGHTS", "DEFAULT_WEIGHTS", "LATENCY_SENSITIVE_WEIGHTS",
    "RealizedNormalization", "UtilityWeights", "realized_utility",
    "selection_utilities",
]
