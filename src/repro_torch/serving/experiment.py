"""The paper's experiment CLI — port of ``repro.serving.experiment``.

Runs one policy over the paper benchmark and writes the Appendix-F CSV; the
full benchmark (7 policies × 28 queries) is :func:`run_all_policies`.

    python -m repro_torch.serving.experiment --all --out results/torch/router_default.csv
"""

from __future__ import annotations

import argparse
import dataclasses
import os

import torch

from repro_torch.core.policies import POLICIES, make_policy
from repro_torch.core.router import RouterConfig
from repro_torch.core.telemetry import TelemetryStore
from repro_torch.core.utility import UtilityWeights
from repro_torch.data.benchmark import BENCHMARK_QUERIES, REFERENCE_ANSWERS
from repro_torch.serving.engine import EngineConfig, build_paper_engine

RESULTS_DIR = "results"

POLICY_TO_CSV = {
    "router_default": "router_default.csv",
    "router_latency_sensitive": "router_latency.csv",
    "router_cost_sensitive": "router_cost.csv",
    "fixed_direct": "fixed_direct.csv",
    "fixed_light": "fixed_light.csv",
    "fixed_medium": "fixed_medium.csv",
    "fixed_heavy": "fixed_heavy.csv",
}


def run_policy(
    policy_name: str,
    *,
    queries=BENCHMARK_QUERIES,
    references=REFERENCE_ANSWERS,
    router_config: RouterConfig = RouterConfig(),
    engine_config: EngineConfig = EngineConfig(),
    out_csv: str | None = None,
    device: str | torch.device = "cuda",
) -> TelemetryStore:
    """Serve the paper benchmark under one policy; optionally write its CSV."""
    router = make_policy(policy_name, config=router_config)
    engine = build_paper_engine(router, config=engine_config, device=device)
    telemetry = engine.run(list(queries), list(references))
    if out_csv:
        telemetry.to_csv(out_csv)
    return telemetry


def run_all_policies(results_dir: str = RESULTS_DIR, **kwargs) -> dict[str, TelemetryStore]:
    """Run the 7 paper policies, writing one CSV each into ``results_dir``."""
    os.makedirs(results_dir, exist_ok=True)
    out = {}
    for name, csv_name in POLICY_TO_CSV.items():
        out[name] = run_policy(name, out_csv=os.path.join(results_dir, csv_name), **kwargs)
    return out


def main(argv: list[str] | None = None) -> None:
    """Command-line entry point."""
    ap = argparse.ArgumentParser(prog="ca-rag-experiment")
    ap.add_argument("--policy", default="router_default", choices=sorted(POLICIES))
    ap.add_argument("--mode", default="router", choices=["router", "fixed"])
    ap.add_argument("--fixed-strategy", default="heavy_rag")
    ap.add_argument("--latency-weight", type=float, default=None)
    ap.add_argument("--cost-weight", type=float, default=None)
    ap.add_argument("--quality-weight", type=float, default=None)
    ap.add_argument("--out", default="results/router_default.csv")
    ap.add_argument("--all", action="store_true", help="run all 7 paper policies")
    ap.add_argument("--no-telemetry-refinement", action="store_true")
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)

    engine_config = EngineConfig(use_telemetry_refinement=not args.no_telemetry_refinement)

    if args.all:
        stores = run_all_policies(
            os.path.dirname(args.out) or RESULTS_DIR,
            engine_config=engine_config,
            device=args.device,
        )
        for name, t in stores.items():
            print(f"{name}: {t.summary_json()}")
        return

    policy = args.policy
    if args.mode == "fixed":
        policy = {
            "direct_llm": "fixed_direct",
            "light_rag": "fixed_light",
            "medium_rag": "fixed_medium",
            "heavy_rag": "fixed_heavy",
        }[args.fixed_strategy]

    router_config = RouterConfig()
    if any(w is not None for w in (args.latency_weight, args.cost_weight, args.quality_weight)):
        w = UtilityWeights(
            quality=args.quality_weight if args.quality_weight is not None else 0.6,
            latency=args.latency_weight if args.latency_weight is not None else 0.2,
            cost=args.cost_weight if args.cost_weight is not None else 0.2,
        )
        router_config = dataclasses.replace(router_config, weights=w)

    t = run_policy(
        policy,
        router_config=router_config,
        engine_config=engine_config,
        out_csv=args.out,
        device=args.device,
    )
    print(t.summary_json())


if __name__ == "__main__":
    main()
