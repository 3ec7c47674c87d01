"""Utility function and normalization (paper §V.C, Eq. 1) — port of ``repro.core.utility``.

Selection utility for bundle ``b`` on query ``q``::

    U_b = w_Q * Qhat_b(q) - w_L * Lhat_b_norm - w_C * Chat_b_norm     (Eq. 1)

with latency and cost min-max normalized across the catalog. The torch
functions run in float32 with the JAX package's operation order; the numpy
mirror (:func:`selection_utilities_np`) is the host path the serving replay
uses, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class UtilityWeights:
    """Operator-specified objective weights (w_Q, w_L, w_C)."""

    quality: float = 0.6
    latency: float = 0.2
    cost: float = 0.2

    def as_tuple(self) -> tuple[float, float, float]:
        """(w_Q, w_L, w_C)."""
        return (self.quality, self.latency, self.cost)


DEFAULT_WEIGHTS = UtilityWeights()
LATENCY_SENSITIVE_WEIGHTS = UtilityWeights(quality=0.6, latency=0.5, cost=0.2)
COST_SENSITIVE_WEIGHTS = UtilityWeights(quality=0.6, latency=0.2, cost=0.5)

DEFAULT_GAMMA = 1.0
DEFAULT_C0 = 0.19
DEFAULT_DELTA = 2.0
DEFAULT_C1 = 0.50
DEFAULT_GLOBAL_DECAY = 1.5


def _f32(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def minmax_normalize(values: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Min-max normalize to [0,1] along ``dim``; constant rows map to 0."""
    values = _f32(values)
    lo = values.amin(dim=dim, keepdim=True)
    hi = values.amax(dim=dim, keepdim=True)
    span = hi - lo
    safe = torch.where(span > 0, span, torch.ones_like(span))
    return torch.where(span > 0, (values - lo) / safe, torch.zeros_like(values))


def modulated_quality(
    quality_prior: torch.Tensor,
    depth_affinity: torch.Tensor,
    complexity: torch.Tensor,
    *,
    gamma: float = DEFAULT_GAMMA,
    c0: float = DEFAULT_C0,
    delta: float = DEFAULT_DELTA,
    c1: float = DEFAULT_C1,
    global_decay: float = DEFAULT_GLOBAL_DECAY,
) -> torch.Tensor:
    """Qhat_b(q): complexity-modulated quality prior, ``(N,)`` × ``(B,)`` → ``(N, B)``."""
    c = _f32(complexity)[..., None]
    q = _f32(quality_prior, c.device)[None, :]
    a = _f32(depth_affinity, c.device)[None, :]
    deep = torch.square(torch.clamp(a, 0.0, 1.0))
    hinge = torch.clamp(c - c1, min=0.0)
    decay = global_decay * torch.clamp(c - c0, min=0.0)
    return torch.clamp(q + gamma * (c - c0) * a + delta * hinge * deep, min=0.0) - decay


def selection_utilities(
    catalog_arrays: Mapping[str, torch.Tensor],
    complexity: torch.Tensor,
    *,
    weights: UtilityWeights = DEFAULT_WEIGHTS,
    gamma: float = DEFAULT_GAMMA,
    c0: float = DEFAULT_C0,
    delta: float = DEFAULT_DELTA,
    c1: float = DEFAULT_C1,
    global_decay: float = DEFAULT_GLOBAL_DECAY,
    latency_override: torch.Tensor | None = None,
    cost_override: torch.Tensor | None = None,
    recall_override: torch.Tensor | None = None,
) -> torch.Tensor:
    """Eq. 1 for a batch of queries: utilities ``(N, B)`` on ``complexity``'s device.

    Overrides may be ``(B,)`` or per-query ``(N, B)``; normalization is per
    row either way (see ``repro.core.utility.selection_utilities``).
    """
    complexity = _f32(complexity)
    dev = complexity.device
    lat = _f32(
        latency_override if latency_override is not None
        else catalog_arrays["latency_prior_ms"], dev,
    )
    cost = _f32(
        cost_override if cost_override is not None
        else catalog_arrays["cost_prior_tokens"], dev,
    )
    quality_prior = _f32(catalog_arrays["quality_prior"], dev)
    recall = (
        recall_override if recall_override is not None
        else catalog_arrays.get("backend_recall")
    )
    if recall is not None:
        quality_prior = quality_prior * _f32(recall, dev)
    qhat = modulated_quality(
        quality_prior,
        catalog_arrays["depth_affinity"],
        complexity,
        gamma=gamma,
        c0=c0,
        delta=delta,
        c1=c1,
        global_decay=global_decay,
    )
    lat_norm = minmax_normalize(lat)
    cost_norm = minmax_normalize(cost)
    if lat_norm.ndim == 1:
        lat_norm = lat_norm[None, :]
    if cost_norm.ndim == 1:
        cost_norm = cost_norm[None, :]
    w_q, w_l, w_c = weights.as_tuple()
    return w_q * qhat - w_l * lat_norm - w_c * cost_norm


def selection_utilities_np(
    catalog_arrays: Mapping[str, np.ndarray],
    complexity: np.ndarray,
    *,
    weights: UtilityWeights = DEFAULT_WEIGHTS,
    gamma: float = DEFAULT_GAMMA,
    c0: float = DEFAULT_C0,
    delta: float = DEFAULT_DELTA,
    c1: float = DEFAULT_C1,
    global_decay: float = DEFAULT_GLOBAL_DECAY,
    latency_override: np.ndarray | None = None,
    cost_override: np.ndarray | None = None,
    recall_override: np.ndarray | None = None,
) -> np.ndarray:
    """Host (numpy) mirror of :func:`selection_utilities`.

    The serving fast path re-routes position-by-position during its exact
    replay, where a device dispatch per query would dominate; this mirror
    runs in microseconds. It is *bit-identical* to the torch path: Eq. 1 uses
    only exactly-rounded IEEE-754 float32 ops (multiply/add/divide, min/max,
    clip — no transcendentals), evaluated here in the same order, with every
    Python-float constant cast to float32 first to mirror jax's weak-type
    promotion (numpy would otherwise promote to float64).
    """
    f32 = np.float32
    c = np.asarray(complexity, f32)[..., None]  # (N, 1)
    quality_prior = np.asarray(catalog_arrays["quality_prior"], f32)
    recall = (
        recall_override if recall_override is not None
        else catalog_arrays.get("backend_recall")
    )
    if recall is not None:
        # same op, same order as the jnp path (backend recall discount)
        quality_prior = quality_prior * np.asarray(recall, f32)
    q = quality_prior[None, :]  # (1, B)
    a = np.asarray(catalog_arrays["depth_affinity"], f32)[None, :]
    deep = np.square(np.clip(a, f32(0.0), f32(1.0)))
    hinge = np.maximum(c - f32(c1), f32(0.0))
    decay = f32(global_decay) * np.maximum(c - f32(c0), f32(0.0))
    qhat = (
        np.maximum(q + f32(gamma) * (c - f32(c0)) * a + f32(delta) * hinge * deep, f32(0.0))
        - decay
    )

    lat = np.asarray(
        latency_override if latency_override is not None else catalog_arrays["latency_prior_ms"],
        f32,
    )
    cost = np.asarray(
        cost_override if cost_override is not None else catalog_arrays["cost_prior_tokens"],
        f32,
    )

    def _minmax(values: np.ndarray) -> np.ndarray:
        lo = values.min(axis=-1, keepdims=True)
        hi = values.max(axis=-1, keepdims=True)
        span = hi - lo
        safe = np.where(span > 0, span, f32(1.0))
        return np.where(span > 0, (values - lo) / safe, np.zeros_like(values))

    lat_norm = _minmax(lat)
    cost_norm = _minmax(cost)
    if lat_norm.ndim == 1:
        lat_norm = lat_norm[None, :]
    if cost_norm.ndim == 1:
        cost_norm = cost_norm[None, :]
    w_q, w_l, w_c = (f32(w) for w in weights.as_tuple())
    return w_q * qhat - w_l * lat_norm - w_c * cost_norm


@dataclasses.dataclass(frozen=True)
class RealizedNormalization:
    """Reference budgets used to normalize *observed* latency/cost for Ũ."""

    latency_ref_ms: float = 2000.0
    cost_ref_tokens: float = 300.0


DEFAULT_REALIZED_NORM = RealizedNormalization()


def realized_utility(
    observed_quality: torch.Tensor,
    observed_latency_ms: torch.Tensor,
    observed_cost_tokens: torch.Tensor,
    *,
    weights: UtilityWeights = DEFAULT_WEIGHTS,
    norm: RealizedNormalization = DEFAULT_REALIZED_NORM,
) -> torch.Tensor:
    """Post-hoc utility Ũ (paper §V.C): Eq. 1 with observed measurements, float32."""
    w_q, w_l, w_c = weights.as_tuple()
    q = _f32(observed_quality)
    lat = w_l * _f32(observed_latency_ms, q.device)
    cost = w_c * _f32(observed_cost_tokens, q.device)
    # full-tensor divisors: see repro_torch.core.signals._div
    return (
        w_q * q
        - lat / torch.full_like(lat, norm.latency_ref_ms)
        - cost / torch.full_like(cost, norm.cost_ref_tokens)
    )
