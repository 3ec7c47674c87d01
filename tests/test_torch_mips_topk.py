"""Port's mips_topk (plain version on the CPU) vs the JAX Pallas kernel.

Inputs are made with numpy from a seed and handed to both packages. The JAX
side runs ``mips_topk_pallas`` in interpret mode and ``mips_topk_ref``.
Tolerances: rows are unit vectors, so fp32 scores agree within 1e-6
absolute (different summation orders over D <= 256); ids agree exactly
except where two candidates' scores lie within that tolerance (a near tie
the two summation orders may break differently).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.mips_topk.kernel import mips_topk_pallas  # noqa: E402
from repro.kernels.mips_topk.ref import mips_topk_ref as jax_ref  # noqa: E402
from repro_torch.kernels.mips_topk import ops, ref  # noqa: E402

SCORE_TOL = 1e-6


def _unit(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def _inputs(q, n, d, seed=0):
    rng = np.random.default_rng(seed)
    return _unit(rng, q, d), _unit(rng, n, d)


def _to_torch(x, dtype):
    return torch.from_numpy(x).to(torch.bfloat16 if dtype == "bfloat16" else torch.float32)


def _to_jax(x, dtype):
    return jnp.asarray(x).astype(jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)


def _full_scores(q_t, c_t):
    return (q_t.double() @ c_t.double().T).numpy()


def assert_topk_agrees(ids, scores, ref_ids, ref_scores, full, tol=SCORE_TOL):
    """Scores within ``tol``; ids equal except at near ties. Returns the
    number of rows with a tie-broken difference."""
    ids, ref_ids = np.asarray(ids), np.asarray(ref_ids)
    np.testing.assert_allclose(np.asarray(scores, np.float64),
                               np.asarray(ref_scores, np.float64), rtol=0, atol=tol)
    rows = set()
    for r, c in zip(*np.nonzero(ids != ref_ids)):
        a, b = ids[r, c], ref_ids[r, c]
        assert abs(full[r, a] - full[r, b]) <= tol, (r, c, a, b)
        rows.add(int(r))
    return len(rows)


# tests/test_kernel_mips_topk.py's sweep: (q, n, d, k, bq, bn, dtype)
SWEEP = [
    (8, 1024, 64, 10, 8, 256, "float32"),
    (4, 2048, 128, 5, 4, 512, "float32"),
    (16, 512, 32, 3, 8, 128, "float32"),
    (8, 1024, 64, 10, 8, 256, "bfloat16"),
    (2, 256, 256, 16, 2, 256, "float32"),
]


@pytest.mark.parametrize("q,n,d,k,bq,bn,dtype", SWEEP)
def test_plain_matches_pallas_interpret(q, n, d, k, bq, bn, dtype):
    qn, cn = _inputs(q, n, d, seed=q * 7 + k)
    jv, ji = mips_topk_pallas(_to_jax(qn, dtype), _to_jax(cn, dtype), k,
                              block_q=bq, block_n=bn, interpret=True)
    rv, ri = jax_ref(_to_jax(qn, dtype), _to_jax(cn, dtype), k)
    qt, ct = _to_torch(qn, dtype), _to_torch(cn, dtype)
    tv, ti = ops.mips_topk(qt, ct, k)
    assert tv.dtype == torch.float32 and ti.dtype == torch.int32
    assert tv.shape == ti.shape == (q, k)
    full = _full_scores(qt.float(), ct.float())
    assert_topk_agrees(ti, tv, ji, jv, full)
    assert_topk_agrees(ti, tv, ri, rv, full)


@pytest.mark.parametrize("n_valid", [1000, 777, 10])
def test_n_valid_mode_matches_pallas(n_valid):
    qn, cn = _inputs(8, 1024, 64, seed=n_valid)
    cn[n_valid:] = 0.0  # zero-padded tail, as DenseIndex pads for the TPU
    k = 5
    jv, ji = mips_topk_pallas(jnp.asarray(qn), jnp.asarray(cn), k, block_q=8,
                              block_n=256, n_valid=n_valid, interpret=True)
    tv, ti = ops.mips_topk(torch.from_numpy(qn), torch.from_numpy(cn), k, n_valid=n_valid)
    assert int(ti.max()) < n_valid
    assert_topk_agrees(ti, tv, ji, jv, _full_scores(torch.from_numpy(qn), torch.from_numpy(cn)))


def test_mask_mode_matches_pallas():
    qn, cn = _inputs(8, 1024, 64, seed=3)
    mask = (np.random.default_rng(4).random(1024) > 0.6).astype(np.float32)
    k = 10
    jv, ji = mips_topk_pallas(jnp.asarray(qn), jnp.asarray(cn), k, block_q=8,
                              block_n=256, valid_mask=jnp.asarray(mask), interpret=True)
    tv, ti = ops.mips_topk(torch.from_numpy(qn), torch.from_numpy(cn), k,
                           mask=torch.from_numpy(mask))
    assert (mask[ti.numpy()] > 0).all()
    assert_topk_agrees(ti, tv, ji, jv, _full_scores(torch.from_numpy(qn), torch.from_numpy(cn)))


def test_tie_heavy_rows_resolve_to_lowest_id():
    """Entries in {-1, 0, 1} make every score an exact small integer, so any
    summation order gives the same float and ties are exact."""
    rng = np.random.default_rng(11)
    base = rng.integers(-1, 2, size=(32, 16)).astype(np.float32)
    corpus = np.concatenate([base, base, base[::-1]])  # 96 rows, each value thrice
    queries = rng.integers(-1, 2, size=(4, 16)).astype(np.float32)
    k = 12
    jv, ji = mips_topk_pallas(jnp.asarray(queries), jnp.asarray(corpus), k,
                              block_q=4, block_n=32, interpret=True)
    tv, ti = ops.mips_topk(torch.from_numpy(queries), torch.from_numpy(corpus), k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    full = queries @ corpus.T
    for r in range(4):
        expect = np.lexsort((np.arange(96), -full[r]))[:k]
        np.testing.assert_array_equal(ti[r].numpy(), expect)


def test_two_pass_plain_versions_compose_to_plain_topk():
    """select_ref + merge_ref (the kernel's passes) equal mips_topk_ref."""
    qn, cn = _inputs(5, 1000, 32, seed=9)
    q, c = torch.from_numpy(qn), torch.from_numpy(cn)
    for k, rows in ((1, 64), (7, 128), (64, 192)):
        v, i = ref.merge_ref(*ref.select_ref(q, c, k, rows), k)
        rv, ri = ref.mips_topk_ref(q, c, k)
        assert torch.equal(v, rv) and torch.equal(i, ri)
    mask = torch.from_numpy((np.arange(1000) % 3 == 0).astype(np.float32))
    v, i = ref.merge_ref(*ref.select_ref(q, c, 10, 64, mask=mask), 10)
    rv, ri = ref.mips_topk_ref(q, c, 10, mask=mask)
    assert torch.equal(v, rv) and torch.equal(i, ri)


def test_wrapper_rejects_bad_requests():
    q, c = torch.randn(4, 16), torch.randn(128, 16)
    with pytest.raises(ValueError):
        ops.mips_topk(q, c, ops.MAX_K + 1)  # the kernel's k limit
    with pytest.raises(ValueError):
        ops.mips_topk(q, c, 200)
    with pytest.raises(ValueError):
        ops.mips_topk(q, c, 5, n_valid=4)  # k > n_valid
    with pytest.raises(ValueError):
        ops.mips_topk(q, c, 5, n_valid=64, mask=torch.ones(128))
    with pytest.raises(TypeError):
        ops.mips_topk(q.double(), c.double(), 5)
    with pytest.raises(ValueError):
        ops.mips_topk(q, c.T, 5)  # shape mismatch
    with pytest.raises(ValueError):
        ops.mips_topk(q, c.T.contiguous().T, 5)  # non-contiguous corpus


def test_cuda_launchers_refuse_cpu_tensors():
    q, c = torch.randn(4, 16), torch.randn(128, 16)
    with pytest.raises(RuntimeError):
        ops.select_pass(q, c, 5)
    with pytest.raises(RuntimeError):
        ops.merge_pass(torch.zeros(4, 2, 5), torch.zeros(4, 2, 5, dtype=torch.int32), 5)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_matches_plain_on_card(cuda_device, dtype):
    qn, cn = _inputs(28, 20_011, 256, seed=5)
    q, c = _to_torch(qn, dtype).to(cuda_device), _to_torch(cn, dtype).to(cuda_device)
    for k in (1, 10, 64):
        v, i = ops.mips_topk(q, c, k)
        rv, ri = ref.mips_topk_ref(q, c, k)
        torch.cuda.synchronize()
        assert_topk_agrees(i.cpu(), v.cpu(), ri.cpu(), rv.cpu(),
                           _full_scores(q.float().cpu(), c.float().cpu()),
                           tol=1e-5 if dtype == "float32" else 1e-2)


@pytest.mark.cuda
def test_kernel_rows_are_batch_invariant(cuda_device):
    qn, cn = _inputs(28, 50_000, 256, seed=6)
    q, c = torch.from_numpy(qn).to(cuda_device), torch.from_numpy(cn).to(cuda_device)
    v, i = ops.mips_topk(q, c, 10)
    for r in range(28):
        vr, ir = ops.mips_topk(q[r : r + 1].contiguous(), c, 10)
        assert torch.equal(vr[0], v[r]) and torch.equal(ir[0], i[r])
