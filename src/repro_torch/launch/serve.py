"""CA-RAG serving entry point, batch mode — port of ``repro.launch.serve``.

    PYTHONPATH=src python -m repro_torch.launch.serve --policy router_default \
        --out results/torch/serve.csv
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --synthetic-docs 1000000 --synthetic-dim 256 --out results/torch/serve_1m.csv

Route → retrieve → generate over the paper queries (or ``--questions``) with
the engine built as ``repro.launch.serve.build_engine_from_opts`` builds it.
``--device`` (default ``cuda``; ``cpu`` on request) places the index and the
engine. The JAX CLI's other flags (streaming, sharding, caching, faults,
guardrail thresholds, scenarios) are not ported yet and are refused.
"""

from __future__ import annotations

import argparse

from repro_torch.core.bundles import make_catalog
from repro_torch.core.policies import make_policy
from repro_torch.core.router import RouterConfig
from repro_torch.core.telemetry import TelemetryStore
from repro_torch.data.benchmark import BENCHMARK_QUERIES, REFERENCE_ANSWERS, corpus_document
from repro_torch.device import resolve_device
from repro_torch.retrieval.backend import make_backends
from repro_torch.retrieval.chunking import line_passages
from repro_torch.retrieval.embedder import HashedNGramEmbedder
from repro_torch.retrieval.index import DenseIndex
from repro_torch.retrieval.synthetic import synthetic_dense_index
from repro_torch.serving.engine import RAGEngine

# Flags of the JAX serve CLI that this port does not carry yet.
UNPORTED_FLAGS = (
    "--min-confidence", "--min-confidence-backend", "--max-cost-tokens", "--cache-size",
    "--shards", "--shard-backends", "--shard-execution", "--remote-backend",
    "--fault-profile", "--retrieve-timeout-ms", "--max-retries", "--request-deadline-ms",
    "--scenario", "--scenario-scale", "--stream", "--rate-qps", "--pipeline-depth",
    "--retrieval-workers", "--executor", "--tokens-per-s", "--seed",
)

ENGINE_OPT_KEYS = (
    "docs", "policy", "catalog", "epsilon", "synthetic_docs", "synthetic_dim",
    "synthetic_seed", "device",
)


def build_engine_from_opts(opts: dict) -> RAGEngine:
    """Build the serving engine from a plain-dict option bag (the keys of
    :data:`ENGINE_OPT_KEYS`)."""
    device = resolve_device(opts["device"])
    catalog = make_catalog(opts["catalog"])
    router = make_policy(
        opts["policy"], catalog=catalog, config=RouterConfig(epsilon=opts["epsilon"])
    )
    if opts["synthetic_docs"] > 0:
        if opts["docs"]:
            raise SystemExit("--synthetic-docs and --docs are mutually exclusive")
        embedder = HashedNGramEmbedder(dim=opts["synthetic_dim"])
        index = synthetic_dense_index(
            opts["synthetic_docs"], opts["synthetic_dim"], seed=opts["synthetic_seed"],
            device=device,
        )
        passages = index.passages
        index_tokens = 0  # nothing was embedded: the corpus is fabricated
    else:
        if opts["docs"]:
            with open(opts["docs"]) as f:
                doc = f.read()
        else:
            doc = corpus_document()
        embedder = HashedNGramEmbedder(dim=256)
        passages = line_passages(doc)
        index, index_tokens = DenseIndex.build(passages, embedder, device=device)
    backends = make_backends(index, passages, embedder, names=("dense", *catalog.backends_used()))
    return RAGEngine(
        router,
        index,
        embedder,
        catalog=router.catalog,
        backends=backends,
        index_embedding_tokens=index_tokens,
        device=device,
    )


def build_parser() -> argparse.ArgumentParser:
    """The batch-mode argument parser."""
    ap = argparse.ArgumentParser(prog="repro_torch.launch.serve")
    ap.add_argument("--docs", default=None, help="newline-separated passages (default: paper corpus)")
    ap.add_argument("--questions", default=None, help="one query per line (default: paper queries)")
    ap.add_argument("--policy", default="router_default")
    ap.add_argument("--catalog", default="paper", choices=("paper", "extended"),
                    help="bundle catalog preset (only 'paper' is ported)")
    ap.add_argument("--out", default="results/serve.csv")
    ap.add_argument("--epsilon", type=float, default=0.0,
                    help="exploration rate (only 0 is ported)")
    ap.add_argument("--synthetic-docs", type=int, default=0, metavar="N",
                    help="replace the corpus with N seeded synthetic documents "
                    "(random unit embeddings + placeholder passages); 0 = real corpus")
    ap.add_argument("--synthetic-dim", type=int, default=64, metavar="D",
                    help="embedding dimension for --synthetic-docs (default 64)")
    ap.add_argument("--synthetic-seed", type=int, default=0,
                    help="RNG seed for the --synthetic-docs corpus")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; an error without a card) or 'cpu'")
    return ap


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    """Parse ``argv``; refuse the JAX CLI's flags that are not ported yet."""
    ap = build_parser()
    args, unknown = ap.parse_known_args(argv)
    for item in unknown:
        flag = item.split("=", 1)[0]
        if flag in UNPORTED_FLAGS:
            raise SystemExit(f"{flag}: not ported yet")
    if unknown:
        ap.error(f"unrecognized arguments: {' '.join(unknown)}")
    return args


def load_queries(args: argparse.Namespace) -> tuple[list[str], list[str] | None]:
    """The query stream: ``--questions`` (no references) or the paper's 28."""
    if args.questions:
        with open(args.questions) as f:
            return [line.strip() for line in f if line.strip()], None
    return list(BENCHMARK_QUERIES), list(REFERENCE_ANSWERS)


def run_batch(engine: RAGEngine, queries, references, out: str) -> TelemetryStore:
    """Serve the queries through ``RAGEngine.run`` and write the Appendix-F CSV."""
    telemetry = engine.run(queries, references)
    telemetry.to_csv(out)
    print(telemetry.summary_json())
    print(f"wrote {len(telemetry.records)} records to {out}")
    return telemetry


def main(argv: list[str] | None = None) -> RAGEngine:
    """Build the engine, serve the queries, write the CSV; returns the engine."""
    args = parse_args(argv)
    queries, references = load_queries(args)
    engine = build_engine_from_opts({key: getattr(args, key) for key in ENGINE_OPT_KEYS})
    run_batch(engine, queries, references, args.out)
    return engine


if __name__ == "__main__":
    main()
