"""The CA-RAG serving engine: route → retrieve → generate → log (paper §IV).

Port of ``repro.serving.engine``. :class:`RAGEngine` composes the five
stages of :mod:`repro_torch.serving.stages`; :meth:`RAGEngine.answer` (one
query) and :meth:`RAGEngine.answer_batch` (the batched fast path, which
:meth:`RAGEngine.run` uses) produce bit-identical records.

Device rule: the engine and :func:`build_paper_engine` take
``device="cuda"`` by default and raise without a card unless the caller
passes ``device="cpu"``. On CUDA, dense retrieval runs through the
hand-written ``mips_topk`` kernel.

Not ported yet: ``serve_batch`` and the continuous-batching scheduler
(decode slice) and recall calibration of non-dense backends.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import numpy as np
import torch

from repro_torch.core.bundles import BundleCatalog, DEFAULT_CATALOG
from repro_torch.core.guardrails import GuardrailConfig, Guardrails
from repro_torch.core.router import Router
from repro_torch.core.telemetry import QueryRecord, TelemetryStore
from repro_torch.core.utility import RealizedNormalization
from repro_torch.device import resolve_device
from repro_torch.retrieval.backend import DenseBackend, RetrievalBackend, make_backends
from repro_torch.retrieval.chunking import line_passages
from repro_torch.retrieval.embedder import CachingEmbedder, Embedder, HashedNGramEmbedder
from repro_torch.retrieval.index import DenseIndex
from repro_torch.serving import stages
from repro_torch.serving.billing import BillingLedger
from repro_torch.serving.generator import ExtractiveGenerator, Generator
from repro_torch.serving.latency import LatencyModel


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Engine knobs: telemetry refinement, guardrails, realized-utility budgets."""
    use_telemetry_refinement: bool = True
    telemetry_min_volume: int = 2
    telemetry_blend: float = 0.35
    warm_start_telemetry: bool = False
    guardrails: GuardrailConfig = GuardrailConfig()
    realized_norm: RealizedNormalization = RealizedNormalization()
    measure_wallclock: bool = False  # also record real pipeline wall time


@dataclasses.dataclass
class EngineResponse:
    """One answered query: answer text, its record and the passages used."""
    answer: str
    record: QueryRecord
    passages: list[str]
    wallclock_ms: float | None = None


class RAGEngine:
    """Route → retrieve → generate → log over one corpus (paper §IV)."""
    def __init__(
        self,
        router: Router,
        index: DenseIndex,
        embedder: Embedder,
        generator: Generator | None = None,
        latency_model: LatencyModel | None = None,
        *,
        catalog: BundleCatalog = DEFAULT_CATALOG,
        config: EngineConfig = EngineConfig(),
        index_embedding_tokens: int = 0,
        backends: Mapping[str, RetrievalBackend] | None = None,
        device: str | torch.device = "cuda",
    ):
        self.device = resolve_device(device)
        if index.device.type != self.device.type:
            raise ValueError(
                f"engine device {self.device} but the index lives on {index.device}"
            )
        self.router = router
        self.index = index
        self.backends: dict[str, RetrievalBackend] = (
            dict(backends) if backends is not None else {}
        )
        self.backends.setdefault("dense", DenseBackend(index))
        missing = [b for b in catalog.backends_used() if b not in self.backends]
        if missing:
            raise ValueError(
                f"catalog routes through backends {missing} but the engine only "
                f"has {sorted(self.backends)}"
            )
        # Query-vector cache: repeated queries skip the embed stage entirely
        # (compute only — τ_embed billing stays per call, Eq. 2).
        self.embedder = (
            embedder if isinstance(embedder, CachingEmbedder) else CachingEmbedder(embedder)
        )
        self.generator = generator or ExtractiveGenerator()
        self.latency_model = latency_model or LatencyModel()
        self.catalog = catalog
        self.config = config
        struct_lat, struct_cost = self._structural_predictions()
        self.telemetry = TelemetryStore(
            catalog,
            min_volume=config.telemetry_min_volume,
            blend=config.telemetry_blend,
            structural_latency=struct_lat,
            structural_cost=struct_cost,
        )
        self.guardrails = Guardrails(catalog, config.guardrails)
        self.ledger = BillingLedger(index_embedding_tokens)
        self._query_counter = 0

    def _structural_predictions(self) -> tuple[np.ndarray, np.ndarray]:
        """Per-bundle end-to-end (latency_ms, billed_tokens) predicted from the
        engine's own latency model + prompt-template token structure."""
        base_prompt = 28  # grounded template + question tokens
        direct_prompt = 16
        tokens_per_passage = 19  # corpus line + citation tag
        embed_tokens = 8
        grounded_completion = 80  # context-constrained answers
        direct_completion = 170  # unconstrained answers run long (§VII.B)
        lat, cost = [], []
        for b in self.catalog:
            backend = self.backends.get(b.backend)
            if b.skip_retrieval:
                prompt = direct_prompt
                completion = direct_completion
                emb = 0
            else:
                prompt = base_prompt + tokens_per_passage * b.top_k
                emb = embed_tokens if backend.requires_query_vecs else 0
                completion = grounded_completion
            stages_ms = self.latency_model.stages_ms(
                embed_tokens=emb,
                retrieval_k=b.top_k,
                prompt_tokens=prompt,
                completion_tokens=completion,
                retrieval_latency_scale=(
                    backend.cost.latency_scale if backend is not None else 1.0
                ),
            )
            lat.append(sum(stages_ms.values()))
            cost.append(prompt + completion + emb)
        return np.asarray(lat, np.float64), np.asarray(cost, np.float64)

    def _priors(self, telemetry: TelemetryStore | None = None):
        """Refined (latency, cost, recall) prior vectors from a telemetry store
        (the live store by default, or a replay clone)."""
        store = telemetry if telemetry is not None else self.telemetry
        if not self.config.use_telemetry_refinement:
            return None, None, None
        recall = store.refined_recall_priors()
        if recall is not None:
            recall = recall.astype(np.float32)
        if self.config.warm_start_telemetry and not store.refinement_active:
            return (
                np.asarray(store.structural_latency, np.float32),
                np.asarray(store.structural_cost, np.float32),
                recall,
            )
        return (
            store.refined_latency_priors().astype(np.float32),
            store.refined_cost_priors().astype(np.float32),
            recall,
        )

    def answer(self, query: str, *, reference: str | None = None) -> EngineResponse:
        """One query through the full stage chain (a single-element
        :meth:`answer_batch`, bit-identical records)."""
        return self.answer_batch([query], [reference])[0]

    def answer_batch(
        self, queries: Sequence[str], references: Sequence[str] | None = None
    ) -> list[EngineResponse]:
        """Serve a whole batch through the vectorized fast path: one routing
        call, one embed call per (backend, k) group's cache misses, one
        ``search_batch`` per (backend, k) group. Records are bit-identical to
        ``[self.answer(q) for q in queries]``."""
        n = len(queries)
        if n == 0:
            return []
        refs = list(references) if references is not None else [None] * n
        if len(refs) != n:
            raise ValueError(f"{n} queries but {len(refs)} references")
        n_records = len(self.telemetry.records)
        routed = stages.route(self, queries, refs)
        try:
            retrieved = stages.retrieve(self, routed)
            admitted = stages.assemble(self, retrieved)
            decoded = stages.decode(self, admitted)
            return stages.finalize(self, decoded)
        except BaseException:
            # return the batch's query ids if it died before committing any
            # record: latency noise is seeded per query_id
            if (
                len(self.telemetry.records) == n_records
                and self._query_counter == routed.qid0 + n
            ):
                self._query_counter = routed.qid0
            raise

    def run(self, queries: Sequence[str], references: Sequence[str] | None = None) -> TelemetryStore:
        """Run a query stream through the batched fast path."""
        self.answer_batch(list(queries), references)
        return self.telemetry


def build_paper_engine(
    policy_router: Router,
    *,
    embed_dim: int = 256,
    config: EngineConfig = EngineConfig(),
    device: str | torch.device = "cuda",
) -> RAGEngine:
    """Engine wired to the paper's benchmark corpus (Appendix E), on ``device``."""
    from repro_torch.data.benchmark import corpus_document

    device = resolve_device(device)
    embedder = HashedNGramEmbedder(dim=embed_dim)
    passages = line_passages(corpus_document())
    index, index_tokens = DenseIndex.build(passages, embedder, device=device)
    catalog = policy_router.catalog
    backends = make_backends(index, passages, embedder, names=("dense", *catalog.backends_used()))
    return RAGEngine(
        policy_router,
        index,
        embedder,
        catalog=catalog,
        config=config,
        index_embedding_tokens=index_tokens,
        backends=backends,
        device=device,
    )
