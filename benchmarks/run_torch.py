"""Benchmark harness of the port: one module per paper table or figure,
on the card unless ``--device`` names another.

    PYTHONPATH=src python -m benchmarks.run_torch [--full] [--device cpu]

Runs Table I (``bench_zoo_torch``), Table III (``bench_overhead_torch``),
Figs 6-15 and Table IV (``bench_partitions_torch``), the <50 ms query
claim (``bench_query_torch``), elastic re-planning
(``bench_elastic_torch``), the serving plane's goodput gate
(``bench_serving_torch``), kernel autotuning with its shared-memory and
tiling pruning gates (``bench_autotune_torch``) and the roofline over the
dry-run's record (``bench_roofline_torch``, which says how to make the
record where it is missing), prints a human-readable report per table and
a machine-readable ``name,us_per_call,derived`` CSV at the end, and exits 1
when any gate failed.
"""

from __future__ import annotations

import argparse
import sys


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true",
                    help="all 18 CNNs / all scenarios (slower)")
    ap.add_argument("--device", default="cuda",
                    help="where the blocks are timed (default: the card)")
    args = ap.parse_args()
    quick, device = not args.full, args.device

    from . import (bench_autotune_torch, bench_elastic_torch,
                   bench_overhead_torch, bench_partitions_torch,
                   bench_query_torch, bench_roofline_torch,
                   bench_serving_torch, bench_zoo_torch)

    rows = []
    rows += bench_zoo_torch.run(quick, device=device)        # Table I
    rows += bench_overhead_torch.run(quick, device=device)   # Table III
    rows += bench_partitions_torch.run(quick, device=device)  # Figs 6-15
    rows += bench_query_torch.run(quick, device=device)      # <50ms query
    rows += bench_elastic_torch.run(quick, device=device)    # re-planning
    rows += bench_autotune_torch.run(quick, device=device)   # autotune gates
    rows += bench_roofline_torch.run(quick)                  # §Roofline
    serving = bench_serving_torch.smoke(device=device)       # goodput gate
    rows.append(("serving/poisson_rel_err", 0.0,
                 serving["poisson"]["rel_err"]))
    rows.append(("serving/replan_swaps", 0.0, serving["replan"]["swaps"]))

    print("\nname,us_per_call,derived")
    for name, us, derived in rows:
        print(f"{name},{us:.1f},{derived}")

    failures = (bench_partitions_torch.failures()
                + bench_query_torch.run.failures
                + bench_serving_torch.failures()
                + bench_autotune_torch.run.failures)
    if failures:
        print("FAILED gates: " + ", ".join(failures))
        sys.exit(1)


if __name__ == "__main__":
    main()
