"""Port's retrieval layer vs the JAX package on the same seeded inputs.

Embedder vectors and synthetic rows are built on the host in numpy by both
packages and must be bit-identical. Dense search (the port's CPU "blocked"
scorer vs JAX's DenseIndex "blocked" scorer) must give equal ids, except at
near ties, and scores within 1e-6 (unit vectors, different summation order).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.data import BENCHMARK_QUERIES, corpus_document  # noqa: E402
from repro.retrieval import (  # noqa: E402
    CachingEmbedder as JaxCachingEmbedder,
    DenseIndex as JaxDenseIndex,
    HashedNGramEmbedder as JaxEmbedder,
    blocked_topk as jax_blocked_topk,
    line_passages as jax_line_passages,
    synthetic_dense_index as jax_synthetic,
)
from repro_torch.convert import index_from_numpy  # noqa: E402
from repro_torch.retrieval import (  # noqa: E402
    CachingEmbedder,
    DenseBackend,
    DenseIndex,
    HashedNGramEmbedder,
    blocked_topk,
    line_passages,
    make_backends,
    synthetic_dense_index,
)
from repro_torch.retrieval.index import Q_BLOCK  # noqa: E402

SCORE_TOL = 1e-6


def _assert_search_agrees(ids, scores, ref_ids, ref_scores, queries, corpus):
    ids, ref_ids = np.asarray(ids), np.asarray(ref_ids)
    np.testing.assert_allclose(np.asarray(scores), np.asarray(ref_scores), rtol=0, atol=SCORE_TOL)
    full = np.asarray(queries, np.float64) @ np.asarray(corpus, np.float64).T
    for r, c in zip(*np.nonzero(ids != ref_ids)):
        assert abs(full[r, ids[r, c]] - full[r, ref_ids[r, c]]) <= SCORE_TOL


def _texts():
    return list(BENCHMARK_QUERIES) + [p.text for p in jax_line_passages(corpus_document())]


@pytest.mark.parametrize("dim", [64, 256])
def test_hashed_embedder_bit_identical(dim):
    texts = _texts()
    ours = HashedNGramEmbedder(dim=dim).embed(texts)
    theirs = np.asarray(JaxEmbedder(dim=dim).embed(texts))
    assert ours.dtype == torch.float32 and ours.device.type == "cpu"
    np.testing.assert_array_equal(ours.numpy(), theirs)


def test_caching_embedder_bit_identical_and_counts():
    texts = _texts()[:10] * 2
    ours, theirs = CachingEmbedder(HashedNGramEmbedder(64)), JaxCachingEmbedder(JaxEmbedder(64))
    np.testing.assert_array_equal(ours.embed(texts).numpy(), np.asarray(theirs.embed(texts)))
    assert (ours.hits, ours.misses) == (theirs.hits, theirs.misses)


def test_synthetic_rows_bit_identical():
    ours = synthetic_dense_index(5_000, 64, seed=3, device="cpu")
    theirs = jax_synthetic(5_000, 64, seed=3)
    np.testing.assert_array_equal(ours.embeddings.numpy(), np.asarray(theirs.embeddings))
    assert [p.text for p in ours.passages[:3]] == [p.text for p in theirs.passages[:3]]


@pytest.mark.parametrize("k", [3, 5, 10])
def test_dense_search_matches_jax_on_paper_corpus(k):
    emb_t, emb_j = HashedNGramEmbedder(256), JaxEmbedder(256)
    passages = line_passages(corpus_document())
    ours, tokens = DenseIndex.build(passages, emb_t, device="cpu")
    theirs, jtokens = JaxDenseIndex.build(jax_line_passages(corpus_document()), emb_j)
    assert tokens == jtokens
    # both indexes re-normalize the embedder's rows: last-bit differences only
    np.testing.assert_allclose(
        ours.embeddings.numpy(), np.asarray(theirs.embeddings), rtol=0, atol=1e-7
    )
    q = emb_t.embed(list(BENCHMARK_QUERIES))
    tv, ti = ours.search_batch(q, k)
    jv, ji = theirs.search_batch(jnp.asarray(q.numpy()), k)
    assert tv.dtype == torch.float32 and ti.dtype == torch.int32
    _assert_search_agrees(ti, tv, ji, jv, q.numpy(), ours.embeddings.numpy())


@pytest.mark.parametrize("nq,k", [(1, 10), (13, 5), (28, 64)])
def test_dense_search_matches_jax_on_synthetic_corpus(nq, k):
    ours = synthetic_dense_index(5_000, 64, seed=1, device="cpu")
    theirs = jax_synthetic(5_000, 64, seed=1)
    rng = np.random.default_rng(nq)
    q = rng.standard_normal((nq, 64)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    tv, ti = ours.search_batch(torch.from_numpy(q), k)
    jv, ji = theirs.search_batch(jnp.asarray(q), k)
    _assert_search_agrees(ti, tv, ji, jv, q, ours.embeddings.numpy())


def test_per_query_results_equal_batched_results():
    index = synthetic_dense_index(3_000, 64, seed=2, device="cpu")
    q = torch.from_numpy(np.random.default_rng(0).standard_normal((2 * Q_BLOCK + 3, 64)).astype(np.float32))
    bv, bi = index.search_batch(q, 7)
    for r in range(q.shape[0]):
        hit = index.search(q[r], 7)
        np.testing.assert_array_equal(hit.passage_ids, bi[r].numpy())
        np.testing.assert_array_equal(hit.scores, bv[r].numpy())
        assert hit.confidence == float(bv[r, 0])


def test_index_from_numpy_round_trip():
    theirs = jax_synthetic(2_000, 32, seed=4)
    rows = np.asarray(theirs.embeddings)
    ours = index_from_numpy(rows, theirs.passages, device="cpu")
    np.testing.assert_array_equal(ours.embeddings.numpy(), rows)
    q = rows[:9] + 0.01
    tv, ti = ours.search_batch(torch.from_numpy(q), 4)
    jv, ji = theirs.search_batch(jnp.asarray(q), 4)
    _assert_search_agrees(ti, tv, ji, jv, q / np.linalg.norm(q, axis=1, keepdims=True), rows)


def test_blocked_topk_matches_jax_with_ties():
    rng = np.random.default_rng(7)
    scores = rng.integers(0, 5, size=(3, 10_000)).astype(np.float32)  # tie-heavy
    for k in (1, 10, 33):
        tv, ti = blocked_topk(torch.from_numpy(scores), k, block=4096)
        jv, ji = jax_blocked_topk(jnp.asarray(scores), k, block=4096)
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def test_dense_backend_delegates_and_other_backends_wait():
    index = synthetic_dense_index(500, 16, seed=0, device="cpu")
    backend = make_backends(index, index.passages, HashedNGramEmbedder(16))["dense"]
    assert isinstance(backend, DenseBackend) and backend.size == 500
    q = index.embeddings[:4]
    v, i = backend.search_batch(["a"] * 4, q, 3)
    rv, ri = index.search_batch(q, 3)
    assert torch.equal(v, rv) and torch.equal(i, ri)
    assert backend.get_passages([1])[0].passage_id == 1
    for name in ("bm25", "ivf", "hybrid"):
        with pytest.raises(NotImplementedError):
            make_backends(index, index.passages, HashedNGramEmbedder(16), names=(name,))


def test_kernel_scorer_refuses_a_cpu_index():
    index = synthetic_dense_index(100, 16, device="cpu")
    with pytest.raises(RuntimeError):
        index.search_batch(index.embeddings[:2], 3, scorer="kernel")
    with pytest.raises(ValueError):
        index.search_batch(index.embeddings[:2], 3, scorer="pallas")
