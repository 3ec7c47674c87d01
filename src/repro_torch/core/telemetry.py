"""Telemetry store and prior refinement (paper §IV.A step 6, §V.C, App. F).

Responsibilities:

* Log per-query execution records in the paper's CSV schema (Appendix F) —
  every figure/table benchmark in ``benchmarks/`` reads *only* these
  artifacts, mirroring the paper's "all results generated directly from
  logged CSV artifacts".
* Maintain per-bundle EMA estimates of observed latency and billed tokens.
  These feed back into utility estimation (§IV.A step 2: "using priors and
  optional telemetry"; corpus line 12: "Telemetry can refine latency and
  quality estimates per bundle after sufficient query volume").
"""

from __future__ import annotations

import csv
import dataclasses
import io
import json
import os
from typing import Iterable, Mapping

import numpy as np

from repro_torch.core.bundles import BundleCatalog, DEFAULT_CATALOG

# Appendix F schema, in order.
CSV_FIELDS: tuple[str, ...] = (
    "query",
    "strategy",
    "bundle",
    "utility",
    "quality_proxy",
    "realized_utility",
    "latency",
    "prompt_tokens",
    "completion_tokens",
    "embedding_tokens",
    "retrieval_confidence",
    "complexity_score",
    "index_embedding_tokens",
)


@dataclasses.dataclass
class QueryRecord:
    """One executed query — the Appendix F row."""

    query: str
    strategy: str
    bundle: str
    utility: float
    quality_proxy: float
    realized_utility: float
    latency: float  # ms, end-to-end
    prompt_tokens: int
    completion_tokens: int
    embedding_tokens: int
    retrieval_confidence: float  # max cosine sim; NaN when retrieval skipped
    complexity_score: float
    index_embedding_tokens: int = 0  # offline bookkeeping (Eq. 2 note)
    # Resilience tagging (serving/resilience.py). Deliberately NOT in
    # CSV_FIELDS: the Appendix-F artifact schema is frozen, and a zero-fault
    # run must stay byte-identical — the tag lives on the record object and
    # in the resilience counters, not in the CSV.
    degraded: bool = False  # answered off-plan via the degradation ladder
    fallback_depth: int = 0  # ladder rungs walked to produce this answer

    @property
    def total_billed_tokens(self) -> int:
        """Eq. 2: τ_billed = τ_prompt + τ_completion + τ_embed."""
        return self.prompt_tokens + self.completion_tokens + self.embedding_tokens

    def as_csv_row(self) -> dict:
        """The record's Appendix-F columns as a dict."""
        d = dataclasses.asdict(self)
        return {k: d[k] for k in CSV_FIELDS}


@dataclasses.dataclass
class BundleStats:
    """Streaming per-bundle statistics with EMA refinement."""

    count: int = 0
    ema_latency_ms: float = float("nan")
    ema_cost_tokens: float = float("nan")
    ema_quality: float = float("nan")
    sum_latency: float = 0.0
    sum_cost: float = 0.0
    sum_quality: float = 0.0

    def update(self, latency_ms: float, cost_tokens: float, quality: float, ema_beta: float):
        """Fold one observation into the running statistics."""
        if self.count == 0:
            self.ema_latency_ms = latency_ms
            self.ema_cost_tokens = cost_tokens
            self.ema_quality = quality
        else:
            b = ema_beta
            self.ema_latency_ms = b * self.ema_latency_ms + (1 - b) * latency_ms
            self.ema_cost_tokens = b * self.ema_cost_tokens + (1 - b) * cost_tokens
            self.ema_quality = b * self.ema_quality + (1 - b) * quality
        self.count += 1
        self.sum_latency += latency_ms
        self.sum_cost += cost_tokens
        self.sum_quality += quality


@dataclasses.dataclass
class RecallStats:
    """Running per-backend ``recall_vs_exact`` observations.

    One observation = one measured recall@k of a backend against exact
    retrieval over some query sample (``RAGEngine.calibrate_backend_recall``
    logs one per query). The refined recall prior shrinks toward the static
    curve until ``count`` clears the store's ``recall_min_samples``.
    """

    count: int = 0
    total: float = 0.0

    def update(self, recall: float) -> None:
        """Fold one observation into the running statistics."""
        self.count += 1
        self.total += recall

    @property
    def mean(self) -> float:
        """Mean of the observations (NaN when there are none)."""
        return self.total / self.count if self.count else float("nan")


class TelemetryStore:
    """Accumulates QueryRecords; provides refined priors + CSV/JSON export.

    ``min_volume`` gates refinement ("after sufficient query volume"): until a
    bundle has that many observations, its static prior is used. ``blend``
    mixes prior and EMA so refinement is gradual and auditable.

    Beyond the latency/cost EMAs, the store also accumulates per-backend
    **recall calibration** observations (:meth:`observe_recall`): measured
    ``recall_vs_exact`` samples that refine each bundle's static backend
    recall prior (:meth:`refined_recall_priors`) once a backend clears
    ``recall_min_samples`` — the live counterpart of the static
    ``BackendCost.recall_prior`` curve (docs/retrieval.md#calibrating-recall-priors-from-telemetry).
    """

    def __init__(
        self,
        catalog: BundleCatalog = DEFAULT_CATALOG,
        *,
        ema_beta: float = 0.7,
        min_volume: int = 1,
        blend: float = 0.5,
        refine_latency: bool = True,
        refine_cost: bool = True,
        structural_latency: np.ndarray | None = None,
        structural_cost: np.ndarray | None = None,
        recall_min_samples: int = 8,
    ):
        self.catalog = catalog
        self.ema_beta = ema_beta
        self.min_volume = min_volume
        self.blend = blend
        self.refine_latency = refine_latency
        self.refine_cost = refine_cost
        # Per-bundle end-to-end predictions from the serving system's own
        # latency/billing models (observed units). Used as the estimate for
        # bundles telemetry hasn't sampled yet, and as the blend anchor.
        self.structural_latency = structural_latency
        self.structural_cost = structural_cost
        self.recall_min_samples = recall_min_samples
        self.records: list[QueryRecord] = []
        self.stats: dict[str, BundleStats] = {name: BundleStats() for name in catalog.names}
        self.recall_obs: dict[str, RecallStats] = {}

    # -- ingestion ----------------------------------------------------------
    def log(self, record: QueryRecord) -> None:
        """Append a record and update its bundle's EMA statistics."""
        self.records.append(record)
        # Degraded answers are forced, not routed: a fault pushed them onto
        # a fallback bundle, so their latency/cost say nothing about what
        # that bundle does under normal routing. They stay in the record
        # stream (auditable, counted) but never refine the EMA priors —
        # injected chaos must not corrupt routing.
        if record.degraded:
            return
        if record.strategy in self.stats:
            self.stats[record.strategy].update(
                record.latency,
                float(record.total_billed_tokens),
                record.quality_proxy,
                self.ema_beta,
            )

    def extend(self, records: Iterable[QueryRecord]) -> None:
        """Log several records in order."""
        for r in records:
            self.log(r)

    def clone_for_replay(self) -> "TelemetryStore":
        """Lightweight copy for speculative what-if replay.

        Carries everything prior refinement reads — per-bundle stats,
        refinement knobs, structural anchors — but not the record history, so
        the serving pipeline's ``finalize`` stage (serving/stages.py) can
        simulate "what priors would query i have seen?" for a whole
        micro-batch without mutating (or deep-copying) the live store.
        Cloning at the finalize boundary — after every earlier micro-batch
        has committed — is what lets the N-deep stage pipeline route
        speculatively on stale priors and still commit position-exact
        records. Logging into the clone updates only the clone.
        """
        clone = TelemetryStore(
            self.catalog,
            ema_beta=self.ema_beta,
            min_volume=self.min_volume,
            blend=self.blend,
            refine_latency=self.refine_latency,
            refine_cost=self.refine_cost,
            structural_latency=self.structural_latency,
            structural_cost=self.structural_cost,
            recall_min_samples=self.recall_min_samples,
        )
        clone.stats = {name: dataclasses.replace(st) for name, st in self.stats.items()}
        clone.recall_obs = {
            name: dataclasses.replace(st) for name, st in self.recall_obs.items()
        }
        return clone

    # -- refined priors -------------------------------------------------------
    @property
    def refinement_active(self) -> bool:
        """True once >= 2 bundles have reached min_volume."""
        ready = sum(
            1 for st in self.stats.values()
            if st.count >= self.min_volume and np.isfinite(st.ema_latency_ms)
        )
        return ready >= 2

    def refined_latency_priors(self) -> np.ndarray:
        """Per-bundle latency estimates for Eq. 1 (consistent units).

        The static base is the *effective* (backend-scaled) prior, so a
        cheap lexical/approximate bundle keeps its latency edge until
        telemetry observes it (×1.0 for dense — bit-identical to the raw
        Table-I prior)."""
        priors = np.array(
            [self.catalog[n].effective_latency_prior_ms for n in self.catalog.names],
            np.float64,
        )
        if not self.refine_latency:
            return priors
        return self._refine(priors, attr="ema_latency_ms", structural=self.structural_latency)

    def refined_cost_priors(self) -> np.ndarray:
        """Per-bundle cost estimates for Eq. 1 (billed tokens)."""
        priors = np.array(
            [self.catalog[n].cost_prior_tokens for n in self.catalog.names], np.float64
        )
        if not self.refine_cost:
            return priors
        return self._refine(priors, attr="ema_cost_tokens", structural=self.structural_cost)

    # -- recall calibration ---------------------------------------------------
    def observe_recall(self, backend: str, recall: float) -> None:
        """Log one measured ``recall_vs_exact`` observation for a backend.

        Observations come from explicit calibration passes (e.g.
        ``RAGEngine.calibrate_backend_recall`` comparing a backend's hits
        against the exact dense backend's), never from the serving hot path,
        so they are constant within any one micro-batch — which is why the
        finalize replay needs no recall staleness handling.
        """
        if not (0.0 <= recall <= 1.0):
            raise ValueError(f"recall must be in [0, 1], got {recall}")
        self.recall_obs.setdefault(backend, RecallStats()).update(float(recall))

    def refined_recall_priors(self) -> np.ndarray | None:
        """Per-bundle backend-recall priors refined from observations.

        Returns ``None`` when **no** backend has reached
        ``recall_min_samples`` — the common case, and the fast path that
        keeps unobserved catalogs (the paper's dense-only regime in
        particular) byte-identical: the routing layer then uses the static
        ``backend_recall`` column exactly as before.

        Otherwise returns a ``(B,)`` float64 vector where each bundle's
        entry is:

        * the **static** curve value (``bundle.backend_cost.recall_prior``)
          when its backend is below the min-sample threshold — the
          shrinkage guard: sparse, noisy recall samples must not move
          routing;
        * otherwise the shrinkage blend
          ``w·mean_observed + (1−w)·static`` with
          ``w = count / (count + recall_min_samples)`` — asymptotically
          trusting the measurements, never snapping to them.

        Dense bundles keep their exact static 1.0 unless someone explicitly
        observes "dense" (exact retrieval has nothing to calibrate), so the
        quality-prior multiply stays the exact identity the paper-catalog
        parity depends on.
        """
        n0 = self.recall_min_samples
        if not any(st.count >= n0 for st in self.recall_obs.values()):
            return None
        out = []
        for name in self.catalog.names:
            bundle = self.catalog[name]
            static = float(bundle.backend_cost.recall_prior)
            obs = self.recall_obs.get(bundle.backend)
            if obs is None or obs.count < n0:
                out.append(static)
                continue
            w = obs.count / (obs.count + n0)
            refined = w * obs.mean + (1.0 - w) * static
            out.append(min(max(refined, 1e-6), 1.0))
        return np.asarray(out, np.float64)

    def _refine(self, priors: np.ndarray, attr: str, structural: np.ndarray | None) -> np.ndarray:
        """Refinement in *observed* units (paper §IV.A step 2: "priors and
        optional telemetry").

        Selection priors (Table I) are naive model-scale estimates; observed
        EMAs are end-to-end. Eq. 1 normalizes across the catalog, so the
        refined vector only needs internally consistent units. Until >= 2
        bundles reach ``min_volume`` the static priors are used unchanged
        ("after sufficient query volume"). Afterwards, per bundle:

        * observed → its EMA;
        * unobserved, when the serving system supplied ``structural``
          end-to-end predictions (from its own latency/billing models) →
          the prediction;
        * unobserved otherwise → a linear fit of EMA vs. top_k over the
          observed retrieval bundles (>= 2 needed), else the prior mapped
          rank-preservingly onto the observed range;
        * then blend with the structural anchor (or mapped prior) by
          ``blend`` — 0 trusts observations fully.
        """
        names = self.catalog.names
        emas = np.array([getattr(self.stats[n], attr) for n in names], np.float64)
        counts = np.array([self.stats[n].count for n in names])
        top_k = np.array([self.catalog[n].top_k for n in names], np.float64)
        is_retrieval = np.array([not self.catalog[n].skip_retrieval for n in names])
        ready = (counts >= self.min_volume) & np.isfinite(emas)
        if ready.sum() < 2:
            return priors
        e_lo, e_hi = emas[ready].min(), emas[ready].max()
        p_lo, p_hi = priors.min(), priors.max()
        if p_hi - p_lo < 1e-9:
            return priors
        span = max(e_hi - e_lo, 1e-9)
        # full-catalog priors mapped into observed units (rank-preserving)
        p_scaled = e_lo + (priors - p_lo) / (p_hi - p_lo) * span
        anchor = np.asarray(structural, np.float64) if structural is not None else p_scaled

        estimate = np.where(ready, emas, anchor)
        if structural is None:
            fit_mask = ready & is_retrieval
            if fit_mask.sum() >= 2:
                b, a = np.polyfit(top_k[fit_mask], emas[fit_mask], 1)
                estimate = np.where((~ready) & is_retrieval, a + b * top_k, estimate)
        return self.blend * anchor + (1 - self.blend) * estimate

    # -- summaries ------------------------------------------------------------
    def strategy_counts(self) -> dict[str, int]:
        """Records per bundle, catalog order."""
        counts = {name: 0 for name in self.catalog.names}
        for r in self.records:
            counts[r.strategy] = counts.get(r.strategy, 0) + 1
        return counts

    def _field_values(self, field: str) -> np.ndarray:
        """Record field as a float vector; ``"cost"`` aliases total billed
        tokens (the Eq. 2 sum) for every aggregate below."""
        if field == "cost":
            return np.asarray([r.total_billed_tokens for r in self.records], np.float64)
        return np.asarray([getattr(r, field) for r in self.records], np.float64)

    def mean(self, field: str) -> float:
        """Mean of the observations (NaN when there are none)."""
        if not self.records:
            return float("nan")
        return float(np.mean(self._field_values(field)))

    def percentile(self, field: str, q: float | Iterable[float]) -> float | np.ndarray:
        """Percentile(s) of a record field over the logged stream — the tail
        view the closed-loop serving benchmarks report (p50/p95 latency vs
        offered load). ``field`` accepts any QueryRecord numeric field or
        ``"cost"`` for total billed tokens."""
        if not self.records:
            qs = np.atleast_1d(np.asarray(q, np.float64))
            out = np.full(qs.shape, np.nan)
            return float(out[0]) if np.isscalar(q) else out
        out = np.percentile(self._field_values(field), q)
        return float(out) if np.isscalar(q) else np.asarray(out)

    def per_strategy_means(self) -> dict[str, dict[str, float]]:
        """Table VI: per-strategy mean ± std of cost / latency / utility."""
        out: dict[str, dict[str, float]] = {}
        for name in self.catalog.names:
            rows = [r for r in self.records if r.strategy == name]
            if not rows:
                continue
            costs = np.array([r.total_billed_tokens for r in rows], np.float64)
            lats = np.array([r.latency for r in rows], np.float64)
            utils = np.array([r.utility for r in rows], np.float64)
            quals = np.array([r.quality_proxy for r in rows], np.float64)
            out[name] = {
                "n": float(len(rows)),
                "mean_cost": float(costs.mean()),
                "std_cost": float(costs.std()),
                "mean_latency": float(lats.mean()),
                "std_latency": float(lats.std()),
                "mean_utility": float(utils.mean()),
                "std_utility": float(utils.std()),
                "mean_quality": float(quals.mean()),
            }
        return out

    def correlation_matrix(self) -> tuple[np.ndarray, list[str]]:
        """Table VII: Pearson correlations among cost/latency/U/complexity."""
        if len(self.records) < 2:
            raise ValueError("need >= 2 records for correlations")
        cols = {
            "cost": [r.total_billed_tokens for r in self.records],
            "lat.": [r.latency for r in self.records],
            "U": [r.utility for r in self.records],
            "cplx.": [r.complexity_score for r in self.records],
        }
        mat = np.corrcoef(np.array(list(cols.values()), np.float64))
        return mat, list(cols.keys())

    # -- export ---------------------------------------------------------------
    def to_csv(self, path: str | None = None) -> str:
        """The records as Appendix-F CSV text; also written to ``path`` if given."""
        buf = io.StringIO()
        writer = csv.DictWriter(buf, fieldnames=list(CSV_FIELDS))
        writer.writeheader()
        for r in self.records:
            writer.writerow(r.as_csv_row())
        text = buf.getvalue()
        if path is not None:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                f.write(text)
            os.replace(tmp, path)  # atomic publish
        return text

    @staticmethod
    def read_csv(path: str) -> list[QueryRecord]:
        """Records back from an Appendix-F CSV file."""
        records = []
        with open(path) as f:
            for row in csv.DictReader(f):
                records.append(
                    QueryRecord(
                        query=row["query"],
                        strategy=row["strategy"],
                        bundle=row["bundle"],
                        utility=float(row["utility"]),
                        quality_proxy=float(row["quality_proxy"]),
                        realized_utility=float(row["realized_utility"]),
                        latency=float(row["latency"]),
                        prompt_tokens=int(row["prompt_tokens"]),
                        completion_tokens=int(row["completion_tokens"]),
                        embedding_tokens=int(row["embedding_tokens"]),
                        retrieval_confidence=float(row["retrieval_confidence"]),
                        complexity_score=float(row["complexity_score"]),
                        index_embedding_tokens=int(row.get("index_embedding_tokens", 0) or 0),
                    )
                )
        return records

    def summary_json(self) -> str:
        """Counts and means of the run as JSON text."""
        return json.dumps(
            {
                "n_queries": len(self.records),
                "strategy_counts": self.strategy_counts(),
                "mean_cost": self.mean("cost"),
                "mean_latency": self.mean("latency"),
                "mean_quality": self.mean("quality_proxy"),
                "mean_utility": self.mean("utility"),
            },
            indent=2,
        )
