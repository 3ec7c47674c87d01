"""Resilience counters — the part of ``repro.serving.resilience`` this slice needs.

The retry/breaker/degradation layer waits for a later slice; the stage
artifacts already carry its counters (all zero here) so records and
artifacts keep the JAX package's shape.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class ResilienceEvents:
    """Typed per-call/per-batch resilience counters."""

    retries: int = 0
    timeouts: int = 0
    failures: int = 0
    short_circuits: int = 0
    breaker_opens: int = 0
    fallbacks: int = 0
    degraded: int = 0
    fallback_depth_total: int = 0

    def add(self, other: "ResilienceEvents") -> "ResilienceEvents":
        """Accumulate ``other`` into self (in place); returns self."""
        for f in dataclasses.fields(self):
            setattr(self, f.name, getattr(self, f.name) + getattr(other, f.name))
        return self

    def as_dict(self) -> dict[str, int]:
        """Plain-dict view for JSON artifacts and run summaries."""
        return dataclasses.asdict(self)

    @property
    def any(self) -> bool:
        """True if any counter is nonzero."""
        return any(getattr(self, f.name) for f in dataclasses.fields(self))
