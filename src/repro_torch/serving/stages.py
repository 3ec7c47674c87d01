"""Typed serving stages: route → retrieve → assemble → decode → finalize.

Port of ``repro.serving.stages``: the engine's route→retrieve→generate→log
loop as five stage functions over explicit artifact dataclasses::

    route(queries)            -> RoutedBatch      (qids, priors, speculation)
    retrieve(RoutedBatch)     -> RetrievedBatch   (searches grouped by (backend, k))
    assemble(RetrievedBatch)  -> AdmittedBatch    (guardrails + prompt build)
    decode(AdmittedBatch)     -> DecodedBatch     (generation, billing, latency)
    finalize(DecodedBatch)    -> list[EngineResponse]  (replay, ledger, telemetry)

``route`` and ``finalize`` are the only stages that touch shared engine
state; ``finalize`` replays the telemetry stream position by position so
batched records are bit-identical to the one-query-at-a-time loop.

Not ported yet: the ``RetrievalFault`` degradation ladder, backend caches,
resilience wrappers and the ``StagePipeline`` executor. Their artifact
fields stay, with zero or empty values, so artifacts keep their shape.
"""

from __future__ import annotations

import dataclasses
import time
from typing import TYPE_CHECKING, Sequence

import numpy as np
import torch

from repro_torch.core.telemetry import QueryRecord
from repro_torch.core.utility import realized_utility
from repro_torch.retrieval.tokenizer import lexical_overlap
from repro_torch.serving.billing import TokenBill, bill_query
from repro_torch.serving.generator import build_prompt
from repro_torch.serving.resilience import ResilienceEvents

if TYPE_CHECKING:  # pragma: no cover - import cycle guard (engine imports us)
    from repro_torch.serving.engine import EngineResponse, RAGEngine

# --------------------------------------------------------------------------- #
# Stage artifacts                                                              #
# --------------------------------------------------------------------------- #
@dataclasses.dataclass
class Execution:
    """Everything downstream of a (query, guarded-bundle) decision.

    Deterministic given (query_id, query, guarded bundle index), so the
    replay pass caches executions across speculation rounds.
    """

    final_bundle_idx: int
    passages: list[str]
    confidence: float
    answer: str
    prompt: str
    bill: TokenBill
    latency_ms: float
    quality: float
    # resilience outcome: True when this answer came off-plan via the
    # degradation ladder (fallback_depth = rungs walked to reach it)
    degraded: bool = False
    fallback_depth: int = 0


@dataclasses.dataclass
class RoutedBatch:
    """Output of :func:`route`: the speculative routing plan for one
    micro-batch, with the query vectors the retrieve stage will search."""

    qid0: int
    queries: list[str]
    references: list[str | None]
    complexity: np.ndarray  # (n,) float
    choices: np.ndarray  # (n,) int32 — speculative routed bundle per query
    utilities: np.ndarray  # (n, B) — Eq. 1 utilities under route-time priors
    guarded: list[int]  # pre-execution guardrail outcome per query
    retrieval_plan: dict[tuple[str, int], list[int]]  # (backend, top_k) → positions
    query_vecs: dict[int, np.ndarray]  # position → (d,) embedded query (vec backends only)
    refinement_on: bool
    t0: float  # perf_counter at route start (wallclock accounting)

    @property
    def n(self) -> int:
        """Number of queries in this micro-batch."""
        return len(self.queries)


@dataclasses.dataclass
class RetrievedBatch:
    """Output of :func:`retrieve`: per-position (scores, ids) rows from the
    backend-grouped batched searches."""

    routed: RoutedBatch
    retrievals: dict[int, tuple[np.ndarray, np.ndarray]]  # position → (k,) rows
    search_calls: int  # search_batch invocations (one per (backend, k) group)
    search_calls_by_backend: dict[str, int] = dataclasses.field(default_factory=dict)
    # per-backend cache hit/miss/eviction deltas incurred by this batch's
    # searches (CachedBackend-wrapped backends only; empty otherwise)
    cache_events: dict[str, dict[str, int]] = dataclasses.field(default_factory=dict)
    # degradation-ladder outcomes: position → bundle index actually served
    # (only positions whose planned backend was unavailable) and the number
    # of ladder rungs walked to get there
    fallback_bundle: dict[int, int] = dataclasses.field(default_factory=dict)
    fallback_depth: dict[int, int] = dataclasses.field(default_factory=dict)
    # typed resilience counters for this batch's searches (retries, timeouts,
    # breaker transitions, ladder outcomes — serving/resilience.py)
    resilience: ResilienceEvents = dataclasses.field(default_factory=ResilienceEvents)


@dataclasses.dataclass
class AdmittedBatch:
    """Output of :func:`assemble`: guardrail-final bundles, fetched passages,
    and built prompts — everything generation needs, no index access left."""

    retrieved: RetrievedBatch
    final_bundle: list[int]  # post-retrieval-guardrail bundle per query
    passages: list[list[str]]
    confidences: list[float]
    prompts: list[str]
    embedded: list[bool]  # did this query spend an embed call (billing)

    @property
    def routed(self) -> RoutedBatch:
        """The originating routing artifact (convenience accessor)."""
        return self.retrieved.routed


@dataclasses.dataclass
class DecodedBatch:
    """Output of :func:`decode`: full executions for the speculative plan,
    keyed for reuse by the replay pass in :func:`finalize`."""

    admitted: AdmittedBatch
    executions: list[Execution]
    exec_cache: dict[tuple[int, int], Execution]  # (position, guarded idx)
    search_calls: int  # retrieve-stage calls; finalize adds replay searches
    search_calls_by_backend: dict[str, int] = dataclasses.field(default_factory=dict)
    cache_events: dict[str, dict[str, int]] = dataclasses.field(default_factory=dict)
    resilience: ResilienceEvents = dataclasses.field(default_factory=ResilienceEvents)

    @property
    def routed(self) -> RoutedBatch:
        """The originating routing artifact (convenience accessor)."""
        return self.admitted.routed


# --------------------------------------------------------------------------- #
# Per-query execution core (shared by decode and the replay pass)              #
# --------------------------------------------------------------------------- #
def execute_one(
    engine: "RAGEngine",
    qid: int,
    query: str,
    routed_idx: int,
    reference: str | None,
) -> DecodedBatch:
    """Run one routed query through retrieve → assemble → decode.

    The replay path's single-query execution. It *is* the batched middle
    stages applied to a one-element plan — not a re-implementation — so it
    can never drift from what the pipeline computed for the speculative
    choices. Embeds on the caller's thread (only ``route``/``finalize`` may
    call this: the embedder cache is confined to those boundaries).

    Returns the one-element :class:`DecodedBatch` (execution at index 0),
    so the caller can also merge its search/cache counters into the
    enclosing batch's totals.
    """
    guarded = engine.guardrails.pre_execution(int(routed_idx)).bundle_index
    bundle = engine.catalog[guarded]
    plan: dict[tuple[str, int], list[int]] = {}
    qvecs: dict[int, np.ndarray] = {}
    if not bundle.skip_retrieval:
        if engine.backends[bundle.backend].requires_query_vecs:
            qvecs[0] = np.asarray(engine.embedder.embed([query]), np.float32)[0]
        plan[(bundle.backend, bundle.top_k)] = [0]
    routed = RoutedBatch(
        qid0=qid,
        queries=[query],
        references=[reference],
        complexity=np.zeros((1,), np.float64),
        choices=np.asarray([routed_idx], np.int32),
        utilities=np.zeros((1, 1), np.float64),
        guarded=[guarded],
        retrieval_plan=plan,
        query_vecs=qvecs,
        refinement_on=False,
        t0=0.0,
    )
    return decode(engine, assemble(engine, retrieve(engine, routed)))


def make_record(
    engine: "RAGEngine",
    qid: int,
    query: str,
    ex: Execution,
    utility: float,
    realized: float,
    *,
    complexity: float = 0.0,
) -> QueryRecord:
    """Build the Appendix-F row for one execution."""
    bundle = engine.catalog[ex.final_bundle_idx]
    return QueryRecord(
        query=query,
        strategy=bundle.name,
        bundle=bundle.name,
        utility=utility,
        quality_proxy=ex.quality,
        realized_utility=realized,
        latency=ex.latency_ms,
        prompt_tokens=ex.bill.prompt_tokens,
        completion_tokens=ex.bill.completion_tokens,
        embedding_tokens=ex.bill.embedding_tokens,
        retrieval_confidence=ex.confidence,
        complexity_score=complexity,
        index_embedding_tokens=engine.ledger.index_embedding_tokens if qid == 0 else 0,
        degraded=ex.degraded,
        fallback_depth=ex.fallback_depth,
    )


# --------------------------------------------------------------------------- #
# Stage 1: route (mutates: query counter, embedder cache)                      #
# --------------------------------------------------------------------------- #
def route(
    engine: "RAGEngine",
    queries: Sequence[str],
    references: Sequence[str | None],
) -> RoutedBatch:
    """Signals → priors → speculative vectorized routing → query embedding.

    The only entry stage: stamps query ids (so pipelined micro-batches keep
    arrival-ordered qids even before earlier batches finalize) and embeds the
    queries the speculative plan will retrieve for (one embed call per k
    group, through the engine's query-vector cache). Must be called serially
    in arrival order.
    """
    t0 = time.perf_counter()
    queries = list(queries)
    refs = list(references)
    n = len(queries)
    qid0 = engine._query_counter

    cplx_np = np.asarray(engine.router.complexity_batch(queries))
    lat0, cost0, rec0 = engine._priors()
    choices, util_np = engine.router.route_batch_np(
        cplx_np, latency_override=lat0, cost_override=cost0, recall_override=rec0
    )

    guarded = [engine.guardrails.pre_execution(int(c)).bundle_index for c in choices]
    plan: dict[tuple[str, int], list[int]] = {}
    for i in range(n):
        bundle = engine.catalog[guarded[i]]
        if not bundle.skip_retrieval:
            plan.setdefault((bundle.backend, bundle.top_k), []).append(i)
    query_vecs: dict[int, np.ndarray] = {}
    for (bname, _k), idxs in plan.items():
        if not engine.backends[bname].requires_query_vecs:
            continue  # lexical backends never spend the embed call
        vecs = np.asarray(engine.embedder.embed([queries[i] for i in idxs]), np.float32)
        for r, i in enumerate(idxs):
            query_vecs[i] = vecs[r]

    # Allocate the ids only once nothing in this stage can fail: a routing
    # or embedding error must not leak qids (latency noise and generator
    # verbosity are seeded per query_id, so a leak would shift every later
    # record off the reference stream). route is contractually serial, so
    # deferring the increment cannot race a concurrent allocation.
    engine._query_counter += n

    return RoutedBatch(
        qid0=qid0,
        queries=queries,
        references=refs,
        complexity=cplx_np,
        choices=choices,
        utilities=util_np,
        guarded=guarded,
        retrieval_plan=plan,
        query_vecs=query_vecs,
        refinement_on=lat0 is not None,
        t0=t0,
    )


# --------------------------------------------------------------------------- #
# Stage 2: retrieve (pure)                                                     #
# --------------------------------------------------------------------------- #
def _search_group(
    engine: "RAGEngine", bname: str, k: int, idxs: list[int], routed: RoutedBatch
) -> tuple[np.ndarray, np.ndarray]:
    """One batched ``search_batch`` for positions ``idxs`` on backend ``bname``;
    returns host (scores float32, ids int32) rows."""
    backend = engine.backends[bname]
    qtexts = [routed.queries[i] for i in idxs]
    qmat = (
        torch.from_numpy(np.stack([routed.query_vecs[i] for i in idxs]))
        if backend.requires_query_vecs
        else None
    )
    scores, ids = backend.search_batch(qtexts, qmat, k)
    return (
        torch.as_tensor(scores).cpu().numpy().astype(np.float32, copy=False),
        torch.as_tensor(ids).cpu().numpy().astype(np.int32, copy=False),
    )


def retrieve(engine: "RAGEngine", routed: RoutedBatch) -> RetrievedBatch:
    """Backend-grouped search: one batched ``search_batch`` call per
    (backend, k) group. Pure given the artifact."""
    retrievals: dict[int, tuple[np.ndarray, np.ndarray]] = {}
    calls = 0
    calls_by: dict[str, int] = {}
    for (bname, k), idxs in routed.retrieval_plan.items():
        scores_np, ids_np = _search_group(engine, bname, k, idxs, routed)
        calls += 1
        calls_by[bname] = calls_by.get(bname, 0) + 1
        for r, i in enumerate(idxs):
            retrievals[i] = (scores_np[r], ids_np[r])
    return RetrievedBatch(
        routed=routed,
        retrievals=retrievals,
        search_calls=calls,
        search_calls_by_backend=calls_by,
    )

# --------------------------------------------------------------------------- #
# Stage 3: assemble (pure) — guardrails + passage fetch + prompt build         #
# --------------------------------------------------------------------------- #
def assemble(engine: "RAGEngine", retrieved: RetrievedBatch) -> AdmittedBatch:
    """Post-retrieval guardrails (low-confidence demotion), passage payload
    fetch, and prompt construction. Pure given the artifact.

    Positions the retrieve stage degraded assemble under their *fallback*
    bundle (``retrieved.fallback_bundle``): passages come from the rung
    backend that actually answered, and the confidence guardrail applies at
    that bundle — a degraded answer still gets demoted to direct inference
    when its fallback retrieval looks unconvincing.
    """
    routed = retrieved.routed
    final_bundle: list[int] = []
    passages_all: list[list[str]] = []
    confidences: list[float] = []
    prompts: list[str] = []
    embedded: list[bool] = []
    for i in range(routed.n):
        bundle_idx = retrieved.fallback_bundle.get(i, routed.guarded[i])
        bundle = engine.catalog[bundle_idx]
        passages: list[str] = []
        confidence = float("nan")
        # retrieval and embedding are now distinct spends: a lexical backend
        # retrieves without ever embedding (billing reads `embedded`)
        did_embed = i in routed.query_vecs
        if not bundle.skip_retrieval:
            scores, ids = retrieved.retrievals[i]
            confidence = float(scores[0]) if scores.size else float("nan")
            post = engine.guardrails.post_retrieval(bundle_idx, confidence)
            if post.demoted:
                bundle_idx = post.bundle_index
                passages = []
            else:
                backend = engine.backends[bundle.backend]
                # drop empty-slot sentinels (id=-1, the backend contract's
                # "no lexical match" marker) before resolving payloads — a
                # sentinel would otherwise wrap to the last passage
                real_ids = ids[ids >= 0] if len(ids) else ids
                passages = [p.text for p in backend.get_passages(real_ids)]
        final_bundle.append(bundle_idx)
        passages_all.append(passages)
        confidences.append(confidence)
        prompts.append(build_prompt(routed.queries[i], passages))
        embedded.append(did_embed)
    return AdmittedBatch(
        retrieved=retrieved,
        final_bundle=final_bundle,
        passages=passages_all,
        confidences=confidences,
        prompts=prompts,
        embedded=embedded,
    )


# --------------------------------------------------------------------------- #
# Stage 4: decode (pure) — generation, billing, latency, quality               #
# --------------------------------------------------------------------------- #
def decode(engine: "RAGEngine", admitted: AdmittedBatch) -> DecodedBatch:
    """Generate per query under its final bundle; bill tokens and sample the
    latency model. Pure given the artifact (generator/latency memo caches
    are idempotent)."""
    routed = admitted.routed
    executions: list[Execution] = []
    exec_cache: dict[tuple[int, int], Execution] = {}
    for i in range(routed.n):
        qid = routed.qid0 + i
        query = routed.queries[i]
        reference = routed.references[i]
        bundle = engine.catalog[admitted.final_bundle[i]]
        answer = engine.generator.generate(
            query, admitted.passages[i], bundle.generation, query_id=qid
        )
        embedded_texts = [query] if admitted.embedded[i] else []
        bill = bill_query(admitted.prompts[i], answer, embedded_texts)
        backend = engine.backends.get(bundle.backend)
        latency_ms = engine.latency_model.sample_ms(
            query_id=qid,
            embed_tokens=bill.embedding_tokens,
            retrieval_k=bundle.top_k,
            prompt_tokens=bill.prompt_tokens,
            completion_tokens=bill.completion_tokens,
            retrieval_latency_scale=(
                backend.cost.latency_scale
                if backend is not None and not bundle.skip_retrieval
                else 1.0
            ),
        )
        quality = (
            lexical_overlap(answer, reference) if reference is not None else float("nan")
        )
        ex = Execution(
            final_bundle_idx=admitted.final_bundle[i],
            passages=admitted.passages[i],
            confidence=admitted.confidences[i],
            answer=answer,
            prompt=admitted.prompts[i],
            bill=bill,
            latency_ms=latency_ms,
            quality=quality,
            degraded=i in admitted.retrieved.fallback_bundle,
            fallback_depth=admitted.retrieved.fallback_depth.get(i, 0),
        )
        executions.append(ex)
        exec_cache[(i, routed.guarded[i])] = ex
    return DecodedBatch(
        admitted=admitted,
        executions=executions,
        exec_cache=exec_cache,
        search_calls=admitted.retrieved.search_calls,
        search_calls_by_backend=dict(admitted.retrieved.search_calls_by_backend),
        cache_events={k: dict(v) for k, v in admitted.retrieved.cache_events.items()},
        resilience=dataclasses.replace(admitted.retrieved.resilience),
    )


# --------------------------------------------------------------------------- #
# Stage 5: finalize (mutates: telemetry, billing ledger; replay fix-up)        #
# --------------------------------------------------------------------------- #
def finalize(engine: "RAGEngine", decoded: DecodedBatch) -> "list[EngineResponse]":
    """Exact replay + commit. Must be called serially, in arrival order.

    Telemetry refinement makes query i's priors a function of queries < i,
    so position-accurate routing is inherently sequential. The heavy stages
    aren't: retrieval/generation depend only on (query, bundle), and the
    speculation already executed them in batch. One cheap host pass replays
    the telemetry stream on a clone, re-routes each position with its true
    priors (microseconds via the numpy mirror), and re-executes only the
    mispredictions — typically none; under a deep pipeline, whatever the
    staleness of the speculative priors required. Then billing, realized
    utility, telemetry append, and response assembly.
    """
    from repro_torch.serving.engine import EngineResponse

    routed = decoded.routed
    n = routed.n
    qid0 = routed.qid0
    queries, refs = routed.queries, routed.references
    choices, util_np = routed.choices, routed.utilities
    executions = list(decoded.executions)

    if routed.refinement_on:
        choices = choices.copy()
        sim = engine.telemetry.clone_for_replay()
        for i in range(n):
            lp, cp, rp = engine._priors(sim)
            ci, ui = engine.router.route_batch_np(
                routed.complexity[i : i + 1],
                latency_override=lp,
                cost_override=cp,
                recall_override=rp,
            )
            util_np[i] = ui[0]
            choice = int(ci[0])
            if choice != choices[i]:
                choices[i] = choice
                guarded = engine.guardrails.pre_execution(choice).bundle_index
                ex = decoded.exec_cache.get((i, guarded))
                if ex is None:
                    sub = execute_one(engine, qid0 + i, queries[i], choice, refs[i])
                    ex = sub.executions[0]
                    # fold the one-element replay execution's search/cache
                    # activity into the batch totals (its plan is empty for
                    # skip-retrieval bundles, so the merge is a no-op there)
                    decoded.search_calls += sub.search_calls
                    by = decoded.search_calls_by_backend
                    for bname, cnt in sub.search_calls_by_backend.items():
                        by[bname] = by.get(bname, 0) + cnt
                    decoded.resilience.add(sub.resilience)
                    decoded.exec_cache[(i, guarded)] = ex
                executions[i] = ex
            sim.log(make_record(engine, qid0 + i, queries[i], executions[i], 0.0, 0.0))

    q_realized = np.asarray(
        [ex.quality if refs[i] is not None else 0.0 for i, ex in enumerate(executions)],
        np.float32,
    )
    lat_arr = np.asarray([ex.latency_ms for ex in executions], np.float32)
    cost_arr = np.asarray([ex.bill.total for ex in executions], np.float32)
    realized = (
        realized_utility(
            torch.from_numpy(q_realized).to(engine.device),
            torch.from_numpy(lat_arr).to(engine.device),
            torch.from_numpy(cost_arr).to(engine.device),
            weights=engine.router.config.weights,
            norm=engine.config.realized_norm,
        )
        .cpu()
        .numpy()
    )

    wall = (
        (time.perf_counter() - routed.t0) * 1000 / n
        if engine.config.measure_wallclock
        else None
    )
    responses = []
    for i, ex in enumerate(executions):
        qid = qid0 + i
        engine.ledger.add(ex.bill)
        record = make_record(
            engine,
            qid,
            queries[i],
            ex,
            float(util_np[i, choices[i]]),
            float(realized[i]),
            complexity=float(routed.complexity[i]),
        )
        engine.telemetry.log(record)
        responses.append(
            EngineResponse(
                answer=ex.answer, record=record, passages=ex.passages, wallclock_ms=wall
            )
        )
    return responses
