"""Query-engine latency in the port (the paper's <50 ms claim, §II-B(vi)):
on the paper-sized testbed over ResNet50's DB timed on the card, and on a
fleet-sized lattice, where the k-best insertion strategy
(``PartitionLattice._push``) dominates query time.

    PYTHONPATH=src python -m benchmarks.bench_query_torch [--full]

Queries run on the host over a cached DB; ``worst`` over the constrained
queries must stay under 50 ms (``failures`` otherwise), and the two push
strategies must return the same k-best configs on the fleet lattice.
"""

from __future__ import annotations

import argparse
import gc
import statistics
import time

from repro_torch.core import Query
from repro_torch.core.partition import PartitionLattice

from .common_torch import benchmark_cached, fleet_engine, scission_for

QUERY_BUDGET_S = 0.05             # the paper's interactive-query claim


class _SortPushLattice(PartitionLattice):
    """The pre-fix insertion strategy: append + full re-sort per relaxed
    edge (O(K log K) each) — kept here only to quantify the improvement of
    the bounded ``bisect.insort`` push on a fleet-sized lattice."""

    @staticmethod
    def _push(store: dict, key, entry, k: int) -> None:
        lst = store.setdefault(key, [])
        lst.append(entry)
        lst.sort(key=lambda e: e[0])
        del lst[k:]


def _time(fn, repeats=3):
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def run(quick: bool = True, device: str = "cuda"):
    run.failures = []
    s = scission_for("4g", device=device)
    benchmark_cached(s, "ResNet50")
    queries = [
        Query(top_n=3),
        Query(top_n=3, must_use=("device", "edge1", "cloud")),
        Query(top_n=3, exclude=("cloud", "cloud_gpu")),
        Query(top_n=3, max_link_bytes={("edge1", "cloud"): 1_000_000}),
        Query(top_n=3, max_resource_time={"device": 1.0}),
        Query(top_n=3, pin={5: "edge1"}),
    ]
    s.query("ResNet50")   # warm cache (paper: queries run on cached data)
    # the garbage of earlier work in this process (a harness runs other
    # benchmarks first) is collected here, not inside one timed query
    gc.collect()
    times = []
    for q in queries * (1 if quick else 5):
        t0 = time.perf_counter()
        s.query("ResNet50", q)
        times.append(time.perf_counter() - t0)
    worst = max(times)
    mean = statistics.fmean(times)
    ok = worst < QUERY_BUDGET_S
    print(f"\n# Query engine: mean={mean * 1e3:.2f}ms "
          f"worst={worst * 1e3:.2f}ms over {len(times)} queries "
          f"(paper budget: 50ms) {'PASS' if ok else 'FAIL'}")
    if not ok:
        run.failures.append(f"query worst {worst * 1e3:.2f} ms >= 50 ms")
    rows = [("query/mean", mean * 1e6, round(mean * 1e3, 3)),
            ("query/worst", worst * 1e6, round(worst * 1e3, 3))]

    # -- fleet-sized lattice: bounded-insort push vs legacy sort-per-insert -
    eng = fleet_engine(n_per_tier=6 if quick else 9,
                       n_blocks=24 if quick else 32)
    cost = eng.cost
    top_n = 8
    repeats = 2 if quick else 3
    t_insort = _time(lambda: PartitionLattice(cost).solve(top_n=top_n),
                     repeats)
    t_sort = _time(lambda: _SortPushLattice(cost).solve(top_n=top_n),
                   repeats)
    want = [c.latency_s for c in PartitionLattice(cost).solve(top_n=top_n)]
    got = [c.latency_s for c in _SortPushLattice(cost).solve(top_n=top_n)]
    if want != got:
        run.failures.append("push strategies disagree on the k-best results")
    speedup = t_sort / t_insort if t_insort > 0 else float("inf")
    print(f"# Fleet lattice ({len(eng.resources)} resources x "
          f"{eng.db.n_blocks} blocks, top_n={top_n}): "
          f"insort-push={t_insort * 1e3:.0f}ms "
          f"sort-push={t_sort * 1e3:.0f}ms speedup={speedup:.2f}x "
          f"{'agree' if want == got else 'DISAGREE'}")
    rows += [("query/fleet_insort_push", t_insort * 1e6,
              round(t_insort * 1e3, 1)),
             ("query/fleet_sort_push", t_sort * 1e6,
              round(t_sort * 1e3, 1)),
             ("query/fleet_push_speedup", 0.0, round(speedup, 2))]
    return rows


run.failures = []


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--full", action="store_true")
    run(quick=not ap.parse_args().full)
    if run.failures:
        raise SystemExit("FAILED: " + "; ".join(run.failures))
