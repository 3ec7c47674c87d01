"""Port's routing core vs the JAX package, for all 7 policies × 28 queries.

Complexity and utilities are float32 in both packages with the same
operation order; they must agree within 1e-6. Chosen bundle indices must be
exactly equal (argmax takes the lowest index on a tie in all paths).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core.bundles import DEFAULT_CATALOG as JAX_CATALOG  # noqa: E402
from repro.core.guardrails import GuardrailConfig as JaxGuardrailConfig  # noqa: E402
from repro.core.guardrails import Guardrails as JaxGuardrails  # noqa: E402
from repro.core.policies import POLICIES as JAX_POLICIES  # noqa: E402
from repro.core.policies import make_policy as jax_make_policy  # noqa: E402
from repro.core.telemetry import QueryRecord as JaxQueryRecord  # noqa: E402
from repro.core.telemetry import TelemetryStore as JaxTelemetryStore  # noqa: E402
from repro.core.utility import realized_utility as jax_realized_utility  # noqa: E402
from repro.data import BENCHMARK_QUERIES  # noqa: E402
from repro_torch.convert import catalog_from_jax_arrays  # noqa: E402
from repro_torch.core import (  # noqa: E402
    DEFAULT_CATALOG,
    POLICIES,
    GuardrailConfig,
    Guardrails,
    QueryRecord,
    RouterConfig,
    TelemetryStore,
    make_policy,
    realized_utility,
)
from repro_torch.core.bundles import make_catalog  # noqa: E402

TOL = 1e-6
QUERIES = list(BENCHMARK_QUERIES)


def _overrides(seed):
    rng = np.random.default_rng(seed)
    lat = rng.uniform(500, 4000, size=4).astype(np.float32)
    cost = rng.uniform(150, 400, size=4).astype(np.float32)
    return lat, cost


def test_policy_registries_match():
    assert list(POLICIES) == list(JAX_POLICIES)


@pytest.mark.parametrize("policy", list(JAX_POLICIES))
def test_complexity_utilities_and_choices_match(policy):
    ours, theirs = make_policy(policy), jax_make_policy(policy)
    c_t = ours.complexity_batch(QUERIES)
    c_j = np.asarray(theirs.complexity_batch(QUERIES))
    np.testing.assert_allclose(c_t.numpy(), c_j, rtol=0, atol=TOL)
    for overrides in (None, _overrides(hash(policy) % 1000)):
        kw = {} if overrides is None else {
            "latency_override": overrides[0], "cost_override": overrides[1]}
        idx_t, u_t = ours.route_batch_arrays(c_t, **{k: torch.from_numpy(v) for k, v in kw.items()})
        idx_j, u_j = theirs.route_batch_arrays(
            jnp.asarray(c_j), **{k: jnp.asarray(v) for k, v in kw.items()})
        assert idx_t.dtype == torch.int32
        np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
        np.testing.assert_allclose(u_t.numpy(), np.asarray(u_j), rtol=0, atol=TOL)
        idx_tn, u_tn = ours.route_batch_np(c_t.numpy(), **kw)
        idx_jn, u_jn = theirs.route_batch_np(c_j, **kw)
        np.testing.assert_array_equal(idx_tn, idx_jn)
        np.testing.assert_array_equal(idx_tn, idx_t.numpy())
        np.testing.assert_allclose(u_tn, u_jn, rtol=0, atol=TOL)


def test_per_query_override_rows_match():
    ours, theirs = make_policy("router_default"), jax_make_policy("router_default")
    c = ours.complexity_batch(QUERIES).numpy()
    rng = np.random.default_rng(1)
    lat = rng.uniform(500, 4000, size=(len(QUERIES), 4)).astype(np.float32)
    idx_t, u_t = ours.route_batch_arrays(torch.from_numpy(c), latency_override=torch.from_numpy(lat))
    idx_j, u_j = theirs.route_batch_arrays(jnp.asarray(c), latency_override=jnp.asarray(lat))
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    np.testing.assert_allclose(u_t.numpy(), np.asarray(u_j), rtol=0, atol=TOL)


def test_argmax_takes_lowest_index_on_a_tie():
    """Two bundles identical but for their names tie exactly on utility."""
    from repro.core.bundles import Bundle as JaxBundle
    from repro.core.bundles import BundleCatalog as JaxBundleCatalog
    from repro.core.router import Router as JaxRouter
    from repro_torch.core import Bundle, BundleCatalog, Router

    spec = [("direct_llm", 0, True, 0.3, 8.0, 190.0, -1.0),
            ("twin_a", 5, False, 0.9, 60.0, 275.0, 1.0),
            ("twin_b", 5, False, 0.9, 60.0, 275.0, 1.0)]
    ours = Router(BundleCatalog([Bundle(*s[:6], depth_affinity=s[6]) for s in spec]))
    theirs = JaxRouter(JaxBundleCatalog([JaxBundle(*s[:6], depth_affinity=s[6]) for s in spec]))
    c = ours.complexity_batch(QUERIES)
    idx_t, u_t = ours.route_batch_arrays(c)
    idx_j, _ = theirs.route_batch_arrays(jnp.asarray(c.numpy()))
    assert torch.equal(u_t[:, 1], u_t[:, 2])
    assert 2 not in idx_t.tolist() and 1 in idx_t.tolist()
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    np.testing.assert_array_equal(ours.route_batch_np(c.numpy())[0], idx_t.numpy())


def test_catalog_arrays_match():
    ours = DEFAULT_CATALOG.as_arrays()
    theirs = {k: np.asarray(v) for k, v in JAX_CATALOG.as_arrays().items()}
    assert set(ours) == set(theirs)
    for k, v in catalog_from_jax_arrays(theirs, device="cpu").items():
        assert v.dtype == ours[k].dtype, k
        np.testing.assert_array_equal(ours[k].numpy(), v.numpy())


def test_realized_utility_matches():
    rng = np.random.default_rng(2)
    q = rng.random(28).astype(np.float32)
    lat = rng.uniform(800, 9000, 28).astype(np.float32)
    cost = rng.integers(100, 500, 28).astype(np.float32)
    ours = realized_utility(torch.from_numpy(q), torch.from_numpy(lat), torch.from_numpy(cost))
    theirs = jax_realized_utility(jnp.asarray(q), jnp.asarray(lat), jnp.asarray(cost))
    assert ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=0, atol=TOL)


@pytest.mark.parametrize("max_cost", [None, 300, 250, 100])
def test_guardrails_match(max_cost):
    ours = Guardrails(DEFAULT_CATALOG, GuardrailConfig(max_cost_tokens=max_cost,
                                                       min_retrieval_confidence=0.3))
    theirs = JaxGuardrails(JAX_CATALOG, JaxGuardrailConfig(max_cost_tokens=max_cost,
                                                           min_retrieval_confidence=0.3))
    for b in range(4):
        assert dataclasses.astuple(ours.pre_execution(b)) == dataclasses.astuple(theirs.pre_execution(b))
        for conf in (0.1, 0.3, 0.9, float("nan")):
            assert (dataclasses.astuple(ours.post_retrieval(b, conf))
                    == dataclasses.astuple(theirs.post_retrieval(b, conf)))


def _records(cls, n, seed):
    rng = np.random.default_rng(seed)
    names = DEFAULT_CATALOG.names
    out = []
    for i in range(n):
        out.append(cls(
            query=f"q{i}", strategy=names[i % 4], bundle=names[i % 4],
            utility=float(rng.random()), quality_proxy=float(rng.random()),
            realized_utility=float(rng.random()), latency=float(rng.uniform(500, 6000)),
            prompt_tokens=int(rng.integers(20, 300)), completion_tokens=int(rng.integers(20, 200)),
            embedding_tokens=int(rng.integers(0, 12)), retrieval_confidence=float(rng.random()),
            complexity_score=float(rng.random()),
        ))
    return out


def test_telemetry_ema_priors_match():
    struct_lat = np.array([1000.0, 1500.0, 1800.0, 2500.0])
    struct_cost = np.array([190.0, 215.0, 275.0, 360.0])
    ours = TelemetryStore(DEFAULT_CATALOG, min_volume=2, blend=0.35,
                          structural_latency=struct_lat, structural_cost=struct_cost)
    theirs = JaxTelemetryStore(JAX_CATALOG, min_volume=2, blend=0.35,
                               structural_latency=struct_lat, structural_cost=struct_cost)
    for r_t, r_j in zip(_records(QueryRecord, 40, 3), _records(JaxQueryRecord, 40, 3)):
        ours.log(r_t)
        theirs.log(r_j)
        np.testing.assert_array_equal(ours.refined_latency_priors(), theirs.refined_latency_priors())
        np.testing.assert_array_equal(ours.refined_cost_priors(), theirs.refined_cost_priors())
        assert ours.refinement_active == theirs.refinement_active
    clone_t, clone_j = ours.clone_for_replay(), theirs.clone_for_replay()
    np.testing.assert_array_equal(clone_t.refined_latency_priors(), clone_j.refined_latency_priors())
    assert ours.to_csv() == theirs.to_csv()
    assert ours.summary_json() == theirs.summary_json()


def test_unported_options_raise():
    with pytest.raises(NotImplementedError):
        make_policy("router_default", config=RouterConfig(epsilon=0.1))
    with pytest.raises(NotImplementedError):
        make_catalog("extended")
