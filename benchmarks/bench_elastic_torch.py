"""Elastic re-planning latency in the port (paper motivation (vi): respond
to operational changes rapidly), over ResNet50's DB timed on the card.

    PYTHONPATH=src python -m benchmarks.bench_elastic_torch

A resource is lost and one joins (its blocks benchmarked incrementally on
``device``); each re-plan's time and plan are printed, then a warm
re-query and the cold and incremental frontier re-plans.
"""

from __future__ import annotations

import time

from repro_torch.core import Query, Resource
from repro_torch.core.resources import EDGE_BOX_2
from repro_torch.models import cnn_zoo
from repro_torch.runtime.elastic import ElasticController

from .common_torch import benchmark_cached, scission_for


def run(quick: bool = True, device: str = "cuda"):
    s = scission_for("4g", device=device)
    graph = cnn_zoo.build("ResNet50", s.device)
    benchmark_cached(s, "ResNet50")
    ctl = ElasticController(s, "ResNet50", graph=graph)

    rows = []
    print("\n# Elastic re-planning (motivation vi)")
    ev = ctl.on_resource_lost("edge1")
    print(f"  drain edge1:   {ev.plan_time_s * 1e3:7.1f}ms -> "
          f"{ev.config.describe()}")
    rows.append(("elastic/drain", ev.plan_time_s * 1e6,
                 round(ev.config.latency_s, 4)))

    ev = ctl.on_resource_joined(Resource("edge3", "edge", EDGE_BOX_2,
                                         speed_factor=2.0))
    print(f"  join edge3:    {ev.plan_time_s * 1e3:7.1f}ms (+ incremental "
          f"benchmark) -> {ev.config.describe()}")
    rows.append(("elastic/join", ev.plan_time_s * 1e6,
                 round(ev.config.latency_s, 4)))

    t0 = time.perf_counter()
    ctl.scission.query("ResNet50", Query(top_n=3))
    warm = time.perf_counter() - t0
    print(f"  warm re-query: {warm * 1e3:7.1f}ms "
          f"({'<50ms PASS' if warm < 0.05 else 'FAIL'})")
    rows.append(("elastic/warm_query", warm * 1e6, round(warm * 1e3, 3)))

    # frontier-mode controllers: the incremental one hands its kept label
    # arrays back to frontier_incremental on each re-plan, so a
    # steady-state network-settle/re-plan cycle replays labels instead of
    # re-running the DP from scratch
    for inc in (False, True):
        s2 = scission_for("4g", device=device)
        benchmark_cached(s2, "ResNet50")
        ctl2 = ElasticController(s2, "ResNet50", graph=graph,
                                 track_frontier=True, incremental=inc)
        ev = ctl2.on_resource_lost("edge1")
        tag = "inc" if inc else "cold"
        print(f"  frontier re-plan ({tag}): {ev.plan_time_s * 1e3:7.1f}ms "
              f"front={ev.frontier_size}")
        rows.append((f"elastic/frontier_replan_{tag}",
                     ev.plan_time_s * 1e6, ev.frontier_size))
    return rows


if __name__ == "__main__":
    run(quick=False)
