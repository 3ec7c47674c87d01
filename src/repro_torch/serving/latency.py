"""Analytic end-to-end latency model with seeded noise.

The paper measures OpenAI API wall-clock; offline we model the same stages
explicitly (per §VI.B "latency depends on retrieval time, reranking, and
model inference time under load"):

    total = embed(τ_e) + retrieve(k) + prefill(τ_prompt) + decode(τ_out)
            all × lognormal noise (seeded per query → reproducible runs)

Defaults are calibrated to the paper's regime (≈1.1–8.3 s end-to-end,
decode-dominated) so distributional claims — direct_llm has the highest
variance because its longer, more variable completions dominate (§VII.B) —
are reproduced mechanistically rather than hard-coded.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class LatencyModelConfig:
    """Per-stage latency coefficients (ms) and the noise seed."""
    embed_base_ms: float = 40.0
    embed_per_token_ms: float = 0.5
    retrieve_base_ms: float = 60.0
    retrieve_per_k_ms: float = 6.0
    prefill_per_token_ms: float = 1.2
    decode_per_token_ms: float = 18.5
    api_overhead_ms: float = 350.0
    noise_sigma: float = 0.30  # lognormal sigma on the total (paper CV ~0.3-0.8)
    seed: int = 99


class LatencyModel:
    """Analytic per-stage latency with seeded lognormal noise per query id."""
    def __init__(self, config: LatencyModelConfig = LatencyModelConfig()):
        self.config = config
        # query_id → lognormal noise factor. The factor is a pure function of
        # (seed, query_id), so caching it only skips Generator construction
        # on the serving hot path — sampled values are unchanged. Bounded:
        # hits only occur within a batch (speculative re-execution), so old
        # entries are dead weight and FIFO eviction never changes a value.
        self._noise_cache: dict[int, float] = {}
        self._noise_cache_max = 8192

    def stages_ms(
        self,
        *,
        embed_tokens: int,
        retrieval_k: int,
        prompt_tokens: int,
        completion_tokens: int,
        retrieval_latency_scale: float = 1.0,
    ) -> dict:
        """Per-stage latency decomposition (ms).

        ``retrieval_latency_scale`` is the retrieval backend's static cost
        multiplier on the retrieve stage (``BackendCost.latency_scale``):
        1.0 is exact dense MIPS — the calibration anchor and an exact
        multiplicative identity, so dense-backend latencies are
        bit-identical to the pre-backend model — while e.g. BM25's 0.25
        makes a lexical bundle's modeled retrieve time reflect that it
        scores postings, not the full embedding matrix.
        """
        c = self.config
        stages = {
            "embed": (c.embed_base_ms + c.embed_per_token_ms * embed_tokens) if embed_tokens else 0.0,
            "retrieve": (c.retrieve_base_ms + c.retrieve_per_k_ms * retrieval_k)
            * retrieval_latency_scale
            if retrieval_k
            else 0.0,
            "prefill": c.prefill_per_token_ms * prompt_tokens,
            "decode": c.decode_per_token_ms * completion_tokens,
            "overhead": c.api_overhead_ms,
        }
        return stages

    def sample_ms(self, *, query_id: int, **stage_kwargs) -> float:
        """Deterministic 'measured' latency for a query (seeded noise)."""
        base = sum(self.stages_ms(**stage_kwargs).values())
        noise = self._noise_cache.get(query_id)
        if noise is None:
            rng = np.random.default_rng((self.config.seed, query_id))
            noise = float(rng.lognormal(mean=0.0, sigma=self.config.noise_sigma))
            # Concurrent decode stages may evict at once; the memo is
            # idempotent so racing writers never change values — eviction
            # just needs to tolerate the dict shifting under it.
            while len(self._noise_cache) >= self._noise_cache_max:
                try:
                    self._noise_cache.pop(next(iter(self._noise_cache)), None)
                except (StopIteration, RuntimeError):
                    break
            self._noise_cache[query_id] = noise
        return base * noise
