#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit:

1. Build the hand-written CUDA ``mips_topk`` kernel from the checkout's
   sources with nvcc (sm_90a) and print the build time.
2. Hold both kernel passes against their plain PyTorch versions on the card:
   fp32 and bf16, D in {64, 256}, k in {1, 3, 5, 10, 64}, ragged N, the
   n_valid and mask modes, exact ties; plus row-by-row batch invariance.
3. The paper path: ``run_all_policies`` (7 policies x 28 queries) on the card
   against the same on the CPU, CSV by CSV.
4. The 1M-passage path: ``repro_torch.launch.serve`` with
   ``--synthetic-docs 1000000 --synthetic-dim 256`` through ``RAGEngine.run``;
   every search held against the index's plain ``"blocked"`` scorer on the
   card; ``answer`` one query at a time must give the same CSV bytes as the
   batch.
5. Times at the main path's shape (Q=28, N=1M, D=256, k=10, fp32): CUDA
   events, warm runs, median of 20.

Tolerances: scores within 1e-5 of the plain version (another summation order
over D <= 256 of unit vectors), for bf16 inputs too: both sides upcast the same
bf16 values and accumulate in fp32, so an accumulation in bf16 (errors near
1e-3) fails. Ids equal except where the plain version's scores of the two ids
lie within that tolerance.
CSV float columns within 1e-6 relative (1e-7 absolute near zero).
Needs the repository's ``src/`` beside this file; imports no JAX.
"""

from __future__ import annotations

import csv
import io
import json
import math
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM published memory rate
FP32_FLOPS = 67e12  # H100 SXM published fp32 (non-tensor-core) rate
FLOAT_FIELDS = {
    "utility", "quality_proxy", "realized_utility", "latency",
    "retrieval_confidence", "complexity_score",
}


def fail(msg: str) -> None:
    """Report a failed check and exit non-zero."""
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def check(cond: bool, msg: str) -> None:
    """Fail with ``msg`` unless ``cond``."""
    if not cond:
        fail(msg)


def compare_topk(ids, scores, ref_ids, ref_scores, full, tol, what) -> tuple[float, int]:
    """Scores within ``tol``; ids equal except at near ties (by the plain
    version's scores ``full``). Returns (max abs score error, rows with a
    tie-broken id difference)."""
    ids, ref_ids = ids.cpu(), ref_ids.cpu()
    s, rs = scores.double().cpu(), ref_scores.double().cpu()
    finite = torch.isfinite(rs)
    check(torch.equal(torch.isfinite(s), finite), f"{what}: empty slots differ")
    err = float((s[finite] - rs[finite]).abs().max()) if finite.any() else 0.0
    check(err <= tol, f"{what}: score error {err} > {tol}")
    diff = (ids != ref_ids).nonzero().tolist()
    rows = set()
    for r, c in diff:
        a, b = int(ids[r, c]), int(ref_ids[r, c])
        gap = abs(float(full[r, a]) - float(full[r, b]))
        check(gap <= tol, f"{what}: row {r} slot {c}: id {a} vs {b}, score gap {gap}")
        rows.add(r)
    return err, len(rows)


def median_ms(fn, reps: int = 20, warm: int = 3) -> float:
    """Median CUDA-event time of ``fn`` over ``reps`` warm runs, in ms."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def csv_agrees(ours: str, theirs: str, what: str) -> None:
    """Two Appendix-F CSVs agree under the float/non-float rule."""
    rows_o = list(csv.DictReader(io.StringIO(ours)))
    rows_t = list(csv.DictReader(io.StringIO(theirs)))
    check(len(rows_o) == len(rows_t) > 0, f"{what}: {len(rows_o)} vs {len(rows_t)} rows")
    for n, (ro, rt) in enumerate(zip(rows_o, rows_t)):
        for key in ro:
            if key not in FLOAT_FIELDS:
                check(ro[key] == rt[key], f"{what} row {n} {key}: {ro[key]!r} vs {rt[key]!r}")
                continue
            a, b = float(ro[key]), float(rt[key])
            same = (math.isnan(a) and math.isnan(b)) or math.isclose(
                a, b, rel_tol=1e-6, abs_tol=1e-7)
            check(same, f"{what} row {n} {key}: {a} vs {b}")


def unit_rows(gen: torch.Generator, n: int, d: int) -> torch.Tensor:
    """``n`` seeded random unit rows of width ``d``."""
    x = torch.randn(n, d, generator=gen)
    return x / x.norm(dim=1, keepdim=True)


def main() -> None:
    """Run the phases in order."""
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a GPU")
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}: run it from a checkout")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import make_policy
    from repro_torch.kernels.mips_topk import ops, ref
    from repro_torch.launch import serve
    from repro_torch.retrieval import DenseBackend, HashedNGramEmbedder
    from repro_torch.serving import RAGEngine
    from repro_torch.serving.experiment import POLICY_TO_CSV, run_all_policies

    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in full fp32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(card)
    driver = subprocess.run(
        ["nvidia-smi", "--query-gpu=driver_version", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, torch cuda "
          f"{torch.version.cuda}, {ops.nvcc_version()}, driver {driver}, "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    # -- 1. build ------------------------------------------------------------
    _, build_s, log = ops.build()
    regs = sorted({ln.split("Used")[1].split(",")[0].strip()
                   for ln in log.splitlines() if "Used" in ln})
    print(f"[1] build: {build_s:.2f} s (nvcc sm_90a); registers per kernel: {regs}", flush=True)

    # -- 2. kernels vs plain versions on the card --------------------------------
    gen = torch.Generator().manual_seed(0)
    err_select = err_merge = 0.0
    tie_rows = cases = 0
    tol = 1e-5
    for dtype in (torch.float32, torch.bfloat16):
        for d in (64, 256):
            for n, mode in ((100_003, "ragged"), (65_536, "n_valid"), (40_000, "mask"),
                            (30_000, "ties")):
                q_n = 40 if mode == "ragged" else 28
                q = unit_rows(gen, q_n, d)
                c = unit_rows(gen, n, d)
                if mode == "ties":
                    c[n // 2:] = c[: n - n // 2]  # every row twice: exact ties
                q, c = q.to(dev, dtype), c.to(dev, dtype)
                kw = {}
                if mode == "n_valid":
                    kw["n_valid"] = n - 777
                if mode == "mask":
                    kw["mask"] = (torch.rand(n, generator=gen) > 0.5).float().to(dev)
                full = ref.score_matrix(q, c, kw.get("n_valid"), kw.get("mask")).cpu()
                for k in (1, 3, 5, 10, 64):
                    what = f"{dtype} D={d} N={n} {mode} k={k}"
                    cand_v, cand_i, rows = ops.select_pass(q, c, k, **kw)
                    rv, ri = ref.select_ref(q, c, k, rows, **kw)
                    e, _ = compare_topk(cand_i.view(q_n, -1), cand_v.view(q_n, -1),
                                        ri.view(q_n, -1), rv.view(q_n, -1), full, tol,
                                        what + " select")
                    err_select = max(err_select, e)
                    out_v, out_i = ops.merge_pass(cand_v, cand_i, k)
                    mv, mi = ref.merge_ref(cand_v, cand_i, k)
                    check(torch.equal(out_i, mi), f"{what} merge ids")
                    err_merge = max(err_merge, float((out_v - mv).abs().max()))
                    pv, pi = ref.mips_topk_ref(q, c, k, **kw)
                    _, t = compare_topk(out_i, out_v, pi, pv, full, tol, what)
                    tie_rows += t
                    cases += 1
                    if mode == "ties":
                        for r in range(q_n):
                            pos = out_v[r, 1:] == out_v[r, :-1]
                            check(bool((out_i[r, 1:][pos] > out_i[r, :-1][pos]).all()),
                                  f"{what}: an exact tie did not go to the lower id")
    check(err_merge == 0.0, f"merge pass moved a score by {err_merge}")
    q = unit_rows(gen, 28, 256).to(dev)
    c = unit_rows(gen, 200_000, 256).to(dev)
    bv, bi = ops.mips_topk(q, c, 10)
    for r in range(28):
        v1, i1 = ops.mips_topk(q[r : r + 1].contiguous(), c, 10)
        check(torch.equal(v1[0], bv[r]) and torch.equal(i1[0], bi[r]),
              f"batch invariance: row {r} alone differs from the batch of 28")
    torch.cuda.synchronize()
    print(f"[2] kernel vs plain: {cases} cases ok; max |score err| select {err_select:.3g}, "
          f"merge {err_merge:.3g}; rows with a near-tie id swap: {tie_rows}; "
          "28 rows alone == batch of 28 (bitwise)", flush=True)

    # -- 3. paper path: card vs CPU ---------------------------------------------
    with tempfile.TemporaryDirectory() as tmp:
        ops.reset_launches()
        stores = run_all_policies(f"{tmp}/cuda", device="cuda")
        torch.cuda.synchronize()
        paper_launches = dict(ops.LAUNCHES)
        run_all_policies(f"{tmp}/cpu", device="cpu")
        for csv_name in POLICY_TO_CSV.values():
            csv_agrees(Path(f"{tmp}/cuda/{csv_name}").read_text(),
                       Path(f"{tmp}/cpu/{csv_name}").read_text(), f"paper {csv_name}")
    check(all(v > 0 for v in paper_launches.values()), f"paper path launches {paper_launches}")
    print(f"[3] paper path, 7 policies x 28 queries: card CSVs match CPU CSVs; "
          f"launches {paper_launches}; router_default routed "
          f"{stores['router_default'].strategy_counts()}", flush=True)

    # -- 4. the 1M-passage path through the serve entry point -------------------
    out_dir = ROOT / "build" / "chip_smoke"
    out_dir.mkdir(parents=True, exist_ok=True)
    args = serve.parse_args(["--synthetic-docs", "1000000", "--synthetic-dim", "256",
                             "--policy", "router_default",
                             "--out", str(out_dir / "serve_1m.csv")])
    queries, references = serve.load_queries(args)
    t0 = time.perf_counter()
    engine = serve.build_engine_from_opts({key: getattr(args, key) for key in serve.ENGINE_OPT_KEYS})
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    check(engine.index.embeddings.is_cuda and engine.index.size == 1_000_000, "1M index not on card")
    calls = []
    dense = engine.backends["dense"]

    class Recording:
        """Passes every search through and keeps its inputs and outputs."""

        name, requires_query_vecs, cost = dense.name, dense.requires_query_vecs, dense.cost
        size = dense.size

        def search_batch(self, qtexts, qvecs, k):
            scores, ids = dense.search_batch(qtexts, qvecs, k)
            calls.append((qvecs.clone(), k, scores.clone(), ids.clone()))
            return scores, ids

        def get_passages(self, ids):
            return dense.get_passages(ids)

    engine.backends["dense"] = Recording()
    ops.reset_launches()
    t0 = time.perf_counter()
    telemetry = serve.run_batch(engine, queries, references, args.out)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    main_launches = dict(ops.LAUNCHES)
    check(all(v > 0 for v in main_launches.values()), f"1M path launches {main_launches}")
    check(len(telemetry.records) == 28, "1M path did not answer 28 queries")
    for rec in telemetry.records:
        check(all(math.isfinite(float(getattr(rec, f))) for f in
                  ("utility", "realized_utility", "latency", "complexity_score")),
              f"non-finite record {rec}")
        retrieval = not engine.catalog[rec.strategy].skip_retrieval
        check(math.isfinite(rec.retrieval_confidence) == retrieval,
              f"retrieval confidence of {rec.strategy}: {rec.retrieval_confidence}")
    swaps = 0
    for qvecs, k, scores, ids in calls:
        pv, pi = engine.index.search_batch(qvecs, k, scorer="blocked")
        qn = engine.index.normalize_queries(qvecs)[: qvecs.shape[0]].to(dev)
        full = ref.score_matrix(qn, engine.index.embeddings).cpu()
        e, t = compare_topk(ids, scores, pi, pv, full, tol, f"1M search k={k}")
        err_select = max(err_select, e)
        swaps += t
    single = RAGEngine(
        make_policy("router_default"), engine.index, HashedNGramEmbedder(256),
        catalog=engine.catalog, backends={"dense": DenseBackend(engine.index)},
        device="cuda",
    )
    for qtext, refr in zip(queries, references):
        single.answer(qtext, reference=refr)
    check(single.telemetry.to_csv() == telemetry.to_csv(),
          "1M path: answer() one at a time differs from answer_batch")
    print(f"[4] 1M x 256 path: setup {setup_s:.1f} s, RAGEngine.run {run_s * 1e3:.1f} ms; "
          f"launches {main_launches}; {len(calls)} searches match the plain blocked scorer "
          f"({swaps} rows with a near-tie swap); max |score err| select so far "
          f"{err_select:.3g}; routed {telemetry.strategy_counts()}; "
          "answer loop CSV == answer_batch CSV", flush=True)

    # -- 5. times at the main path's shape --------------------------------------
    corpus = engine.index.embeddings
    qn = engine.index.normalize_queries(engine.embedder.embed(queries))[:28].to(dev)
    q_n, k = 28, 10
    (n, d) = corpus.shape
    cand_v, cand_i, rows = ops.select_pass(qn, corpus, k)
    width = cand_v[0].numel()
    t_select = median_ms(lambda: ops.select_pass(qn, corpus, k))
    t_merge = median_ms(lambda: ops.merge_pass(cand_v, cand_i, k))
    t_kernel = median_ms(lambda: ops.mips_topk(qn, corpus, k))
    t_plain = median_ms(lambda: ref.mips_topk_ref(qn, corpus, k), reps=20, warm=2)
    t_select_plain = median_ms(lambda: ref.select_ref(qn, corpus, k, rows), reps=20, warm=2)
    t_merge_plain = median_ms(lambda: ref.merge_ref(cand_v, cand_i, k))
    t_lib = median_ms(lambda: torch.topk(qn @ corpus.T, k))
    t_merge_lib = median_ms(lambda: torch.topk(cand_v.view(q_n, -1), k))
    sel_bytes = (n * d + q_n * d) * 4 + q_n * width * 8
    sel_ops = 2 * q_n * n * d
    sel_bound = max(sel_bytes / HBM_BYTES_PER_S, sel_ops / FP32_FLOPS) * 1e3
    sel_by = "bytes" if sel_bytes / HBM_BYTES_PER_S >= sel_ops / FP32_FLOPS else "operations"
    mrg_bytes = q_n * width * 8 + q_n * k * 8
    mrg_ops = q_n * width  # one comparison per candidate
    mrg_bound = max(mrg_bytes / HBM_BYTES_PER_S, mrg_ops / FP32_FLOPS) * 1e3
    per_run = main_launches["mips_topk_select"] + main_launches["mips_topk_merge"]
    print(f"[5] Q={q_n} N={n} D={d} k={k} fp32 ({rows} rows x {width // k} splits): "
          f"kernel {t_kernel:.4f} ms (select {t_select:.4f} + merge {t_merge:.4f}); "
          f"plain {t_plain:.4f} ms; library torch.topk(q @ c.T) {t_lib:.4f} ms; "
          f"bound {sel_bound + mrg_bound:.4f} ms (bytes {sel_bytes / 1e9:.3f} GB at 3.35 TB/s); "
          f"launches per RAGEngine.run {per_run}; card {card}", flush=True)
    source = "src/repro_torch/kernels/mips_topk/csrc/mips_topk.cu"
    print(json.dumps({"kernels": [
        {"name": "mips_topk_select", "route": "cuda", "source": source,
         "replaces": "src/repro/kernels/mips_topk/kernel.py:70",
         "launches": main_launches["mips_topk_select"], "max_abs_err": err_select,
         "ms": t_select, "plain_ms": t_select_plain, "bound_ms": sel_bound,
         "bound_by": sel_by, "library_ms": t_lib},
        {"name": "mips_topk_merge", "route": "cuda", "source": source,
         "replaces": "src/repro/kernels/mips_topk/kernel.py:39",
         "launches": main_launches["mips_topk_merge"], "max_abs_err": err_merge,
         "ms": t_merge, "plain_ms": t_merge_plain, "bound_ms": mrg_bound,
         "bound_by": "bytes" if mrg_bytes / HBM_BYTES_PER_S >= mrg_ops / FP32_FLOPS
         else "operations", "library_ms": t_merge_lib},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
