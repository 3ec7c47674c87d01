"""Serving layer (port of ``repro.serving``): typed stages and the RAG engine."""

from repro_torch.serving.billing import BillingLedger, TokenBill, bill_query
from repro_torch.serving.engine import (
    EngineConfig,
    EngineResponse,
    RAGEngine,
    build_paper_engine,
)
from repro_torch.serving.generator import ExtractiveGenerator, build_prompt
from repro_torch.serving.latency import LatencyModel, LatencyModelConfig
from repro_torch.serving.resilience import ResilienceEvents
from repro_torch.serving.stages import (
    AdmittedBatch,
    DecodedBatch,
    Execution,
    RetrievedBatch,
    RoutedBatch,
    assemble,
    decode,
    finalize,
    retrieve,
    route,
)

__all__ = [
    "BillingLedger", "TokenBill", "bill_query", "EngineConfig", "EngineResponse",
    "RAGEngine", "build_paper_engine", "ExtractiveGenerator", "build_prompt",
    "LatencyModel", "LatencyModelConfig", "ResilienceEvents", "AdmittedBatch",
    "DecodedBatch", "Execution", "RetrievedBatch", "RoutedBatch", "assemble",
    "decode", "finalize", "retrieve", "route",
]
