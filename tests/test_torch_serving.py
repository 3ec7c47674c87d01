"""The slice as a whole: the port's serving path on the CPU vs the JAX package.

CSV comparison rule: every non-float column identical; float columns within
1e-6 relative, 1e-7 absolute near zero (retrieval confidences are cosine
scores summed in another order; everything downstream is float32 in both).
"""

import csv
import io
import math
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.launch import serve as jax_serve  # noqa: E402
from repro.serving.experiment import run_all_policies as jax_run_all  # noqa: E402
from repro_torch.core import make_policy  # noqa: E402
from repro_torch.core.telemetry import CSV_FIELDS  # noqa: E402
from repro_torch.data.benchmark import BENCHMARK_QUERIES, REFERENCE_ANSWERS  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.serving import RAGEngine, build_paper_engine  # noqa: E402
from repro_torch.serving.experiment import POLICY_TO_CSV, run_all_policies  # noqa: E402

FLOAT_FIELDS = {
    "utility", "quality_proxy", "realized_utility", "latency",
    "retrieval_confidence", "complexity_score",
}


def assert_csv_agrees(ours: str, theirs: str) -> None:
    rows_o = list(csv.DictReader(io.StringIO(ours)))
    rows_t = list(csv.DictReader(io.StringIO(theirs)))
    assert len(rows_o) == len(rows_t) > 0
    for ro, rt in zip(rows_o, rows_t):
        assert list(ro) == list(rt) == list(CSV_FIELDS)
        for key in CSV_FIELDS:
            if key not in FLOAT_FIELDS:
                assert ro[key] == rt[key], (key, ro[key], rt[key])
                continue
            a, b = float(ro[key]), float(rt[key])
            if math.isnan(a) or math.isnan(b):
                assert math.isnan(a) and math.isnan(b), key
            else:
                assert math.isclose(a, b, rel_tol=1e-6, abs_tol=1e-7), (key, a, b)


def _read(path):
    with open(path) as f:
        return f.read()


def test_all_policies_match_jax(tmp_path):
    ours = run_all_policies(str(tmp_path / "torch"), device="cpu")
    theirs = jax_run_all(str(tmp_path / "jax"))
    assert list(ours) == list(theirs) == list(POLICY_TO_CSV)
    for name, csv_name in POLICY_TO_CSV.items():
        assert_csv_agrees(_read(tmp_path / "torch" / csv_name), _read(tmp_path / "jax" / csv_name))
        assert ours[name].strategy_counts() == theirs[name].strategy_counts()


@pytest.mark.parametrize("policy", ["router_default", "router_cost_sensitive", "fixed_heavy"])
def test_answer_loop_equals_answer_batch(policy):
    batched = build_paper_engine(make_policy(policy), device="cpu")
    batched.answer_batch(list(BENCHMARK_QUERIES), list(REFERENCE_ANSWERS))
    looped = build_paper_engine(make_policy(policy), device="cpu")
    for q, r in zip(BENCHMARK_QUERIES, REFERENCE_ANSWERS):
        looped.answer(q, reference=r)
    assert looped.telemetry.to_csv() == batched.telemetry.to_csv()


def test_serve_synthetic_matches_jax_serve(tmp_path, monkeypatch, capsys):
    flags = ["--synthetic-docs", "2000", "--synthetic-dim", "64", "--synthetic-seed", "5"]
    engine = serve.main([*flags, "--device", "cpu", "--out", str(tmp_path / "torch.csv")])
    assert engine.device.type == "cpu" and engine.index.size == 2000
    monkeypatch.setattr(sys, "argv", ["serve", *flags, "--out", str(tmp_path / "jax.csv")])
    jax_serve.main()
    out = capsys.readouterr().out
    assert "wrote 28 records" in out
    assert_csv_agrees(_read(tmp_path / "torch.csv"), _read(tmp_path / "jax.csv"))


def _record_searches(monkeypatch, backend_cls, calls):
    """Wrap ``backend_cls.search_batch`` to log each call's (rows, k)."""
    inner = backend_cls.search_batch

    def search_batch(self, queries, query_vecs, k):
        calls.append((len(queries), k))
        return inner(self, queries, query_vecs, k)

    monkeypatch.setattr(backend_cls, "search_batch", search_batch)


def test_search_calls_match_jax_serve(tmp_path, monkeypatch):
    """The same searches, finalize's single-query replays included, in the
    same order: the port issues as many corpus passes as the reference."""
    from repro.retrieval.backend import DenseBackend as JaxDenseBackend
    from repro_torch.retrieval.backend import DenseBackend

    flags = ["--synthetic-docs", "2000", "--synthetic-dim", "256", "--synthetic-seed", "0"]
    ours, theirs = [], []
    _record_searches(monkeypatch, DenseBackend, ours)
    _record_searches(monkeypatch, JaxDenseBackend, theirs)
    serve.main([*flags, "--device", "cpu", "--out", str(tmp_path / "torch.csv")])
    monkeypatch.setattr(sys, "argv", ["serve", *flags, "--out", str(tmp_path / "jax.csv")])
    jax_serve.main()
    assert ours == theirs and len(ours) > 0


def test_serve_paper_corpus_matches_jax_serve(tmp_path, monkeypatch):
    serve.main(["--device", "cpu", "--policy", "fixed_medium", "--out", str(tmp_path / "t.csv")])
    monkeypatch.setattr(sys, "argv", ["serve", "--policy", "fixed_medium",
                                      "--out", str(tmp_path / "j.csv")])
    jax_serve.main()
    assert_csv_agrees(_read(tmp_path / "t.csv"), _read(tmp_path / "j.csv"))


@pytest.mark.parametrize("argv", [["--stream"], ["--shards", "2"], ["--cache-size=8"],
                                  ["--scenario", "zipf-cache"]])
def test_serve_refuses_unported_flags(argv):
    with pytest.raises(SystemExit, match="not ported yet"):
        serve.parse_args(argv)


def test_engine_serves_a_caller_built_index():
    from repro_torch.retrieval import HashedNGramEmbedder, synthetic_dense_index

    index = synthetic_dense_index(100, 16, device="cpu")
    engine = RAGEngine(make_policy("router_default"), index, HashedNGramEmbedder(16), device="cpu")
    assert engine.backends["dense"].index is index
    records = engine.run(["What is RAG?"], ["RAG retrieves documents."]).records
    assert len(records) == 1 and records[0].strategy in engine.catalog.names
    assert np.isfinite(records[0].realized_utility)
