"""Elastic re-planning in the port (the paper's 'operational change'
scenario), with ResNet50's blocks timed on the card.

    PYTHONPATH=src python examples/elastic_repartition_torch.py

Starts with the full testbed, then: (1) the edge box is drained for
maintenance, (2) the network degrades from 4G to 3G, (3) a new edge
resource joins (benchmarked incrementally on the card).  Each event
triggers a re-plan from cached benchmark data — well inside the paper's
50 ms budget.
"""

import sys
import time

sys.path.insert(0, "src")
sys.path.insert(0, ".")

from benchmarks.common_torch import (NETWORKS, benchmark_cached,  # noqa: E402
                                     card_line, fp32_flags, scission_for)
from repro_torch.core import Query, Resource, paper_network  # noqa: E402
from repro_torch.core.resources import EDGE_BOX_2  # noqa: E402
from repro_torch.models import cnn_zoo  # noqa: E402
from repro_torch.runtime.elastic import ElasticController  # noqa: E402


def main():
    print(f"card: {card_line()}; flags {fp32_flags()}")
    s = scission_for("4g")
    graph = cnn_zoo.build("ResNet50", s.device)
    benchmark_cached(s, "ResNet50")

    ctl = ElasticController(s, "ResNet50", graph=graph)
    print("initial:", ctl.current.describe())

    ev = ctl.on_resource_lost("edge1")
    print(f"\n[edge1 drained] re-planned in {ev.plan_time_s * 1e3:.1f}ms")
    print("   ->", ev.config.describe())

    net3g = paper_network(NETWORKS["3g"], edges=("edge2",),
                          clouds=("cloud", "cloud_gpu"))
    ev = ctl.on_network_change(net3g)
    print(f"\n[4G -> 3G] re-planned in {ev.plan_time_s * 1e3:.1f}ms")
    print("   ->", ev.config.describe())

    new_edge = Resource("edge3", "edge", EDGE_BOX_2, speed_factor=2.0)
    ev = ctl.on_resource_joined(new_edge)
    print(f"\n[edge3 joined] benchmarked incrementally on the card + "
          f"re-planned in {ev.plan_time_s * 1e3:.1f}ms (includes Step-3 "
          "enumeration)")
    print("   ->", ev.config.describe())

    # the paper's 50ms budget applies to queries over cached benchmark
    # data; the first query after a membership change also (re)builds the
    # enumeration cache — every subsequent query is warm:
    t0 = time.perf_counter()
    ctl.scission.query("ResNet50", Query(top_n=3))
    warm = time.perf_counter() - t0
    print(f"\nwarm re-query after all changes: {warm * 1e3:.1f}ms")
    if warm >= 0.05:
        raise SystemExit("warm query exceeded the 50ms budget")
    print("warm queries < 50ms ✓")


if __name__ == "__main__":
    main()
