"""Benchmark harness of the port — one module per paper table/figure.

    python -m repro_torch.benchmarks.run [--full] [--only NAME] \\
        [--device cuda|cpu]

prints ``name,us_per_call,derived`` CSV rows (tables write their JSON
under ``results/bench_torch/``).  The tables run on the card
(``--device cuda``, the default); without one it stops with an error
unless ``--device cpu`` is given.  It exits non-zero if any table fails.

``cluster_scaling`` spawns the generator's CLI (serial, then a 2-worker
cluster).  ``roofline`` reads the port's dry-run JSONs
(``python -m repro_torch.launch.dryrun --all --mesh both`` first; it
needs no card).
"""
from __future__ import annotations

import argparse
import importlib
import sys
import time
import traceback

import torch

TABLES = [
    "table2_quality",
    "fig2_distributions",
    "table3_scaling",
    "table5_scale_metrics",
    "table6_ablation",
    "table8_er_timings",
    "table10_structural_stats",
    "fig8_throughput",
    "gnn_throughput",
    "roofline",
    "datastream_throughput",
    "feature_throughput",
    "executor_overlap",
    "fit_throughput",
    "cluster_scaling",
]


def run_table(name: str, fast: bool, device: str):
    """One table's ``run`` (its rows, or its result dict)."""
    mod = importlib.import_module(f"repro_torch.benchmarks.{name}")
    return mod.run(fast=fast, device=device)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--full", action="store_true",
                    help="paper-scale sizes (slow)")
    ap.add_argument("--only", default=None, choices=TABLES)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("benchmarks: no CUDA card is visible; pass "
                         "--device cpu to run the tables on the CPU")
    print("name,us_per_call,derived")
    failures = []
    for name in TABLES:
        if args.only and args.only != name:
            continue
        t0 = time.time()
        try:
            run_table(name, not args.full, args.device)
            print(f"# {name} done in {time.time() - t0:.1f}s",
                  file=sys.stderr)
        except Exception as e:  # noqa: BLE001 — report, run the rest
            failures.append(name)
            print(f"# {name} FAILED: {type(e).__name__}: {e}",
                  file=sys.stderr)
            traceback.print_exc()
    if failures:
        raise SystemExit(f"benchmarks failed: {failures}")


if __name__ == "__main__":
    main()
