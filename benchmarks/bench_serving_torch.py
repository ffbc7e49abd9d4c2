"""Serving-plane benchmark in the port: open-loop arrival traces through
the request router at a frontier-chosen operating point of MobileNetV2,
whose DB is timed on ``device`` (the card unless the caller passes
another).

The end-to-end story the request plane exists for:

1. benchmark the model on the testbed (Steps 1-3, disk-cached),
2. ask :meth:`Scission.frontier` for the Pareto set and pick the
   highest-throughput operating point,
3. serve a seeded open-loop Poisson trace (offered at ~1.2x the point's
   predicted capacity, so the plane saturates) through the
   :class:`~repro_torch.serving.router.Router`,
4. gate: steady-state measured **goodput** must land within 30% of the
   cost model's ``throughput_rps`` prediction for that point,
5. repeat under a bursty-diurnal trace with an SLO (admission control
   sheds the burst overflow at the front door),
6. re-plan live: an :class:`~repro_torch.runtime.elastic.ElasticController`
   loses a resource mid-trace, its re-plan event swaps the router's
   operating point with zero dropped in-flight requests.

Run in smoke mode::

    PYTHONPATH=src python -m benchmarks.bench_serving_torch --smoke \
        --out results/bench_serving_torch_smoke.json
"""

from __future__ import annotations

import argparse
import json
import os

from repro_torch.core import Query, THROUGHPUT
from repro_torch.runtime.elastic import ElasticController
from repro_torch.serving import Router, bursty_diurnal_trace, poisson_trace

from .common_torch import benchmark_cached, scission_for

GOODPUT_TOLERANCE = 0.30          # measured vs predicted, saturated plane
MODEL = "MobileNetV2"
BATCHES = (1, 2, 4)
REPLICAS = {"edge1": 2, "edge2": 2, "cloud": 2, "cloud_gpu": 2}


def _frontier_point(scission, quick=True):
    """Highest-predicted-throughput point of the Pareto frontier over the
    measured batch sizes and a two-replica budget per offload tier."""
    q = Query(objective=THROUGHPUT, batch_sizes=BATCHES, replicas=REPLICAS)
    res = scission.frontier(MODEL, q, input_bytes=150e3)
    point = max(res.configs, key=lambda c: c.throughput_rps)
    return point, res


def scenario_poisson(point, quick=True):
    """Saturated Poisson trace; gates goodput against the prediction."""
    pred = point.throughput_rps
    # virtual-time horizon: the router simulates, so longer = tighter
    # steady state at negligible real cost
    horizon = 80.0 if quick else 400.0
    trace = poisson_trace(rate_rps=1.2 * pred, horizon_s=horizon, seed=0)
    router = Router(point, slo_s=None)
    rep = router.serve(trace)
    rel_err = abs(rep.goodput_rps - pred) / pred
    print(f"  poisson: offered={rep.offered_rps:.2f} rps  "
          f"predicted={pred:.2f} rps  goodput={rep.goodput_rps:.2f} rps  "
          f"rel_err={rel_err:.1%}  p50={rep.latency_p50_s * 1e3:.1f} ms  "
          f"p99={rep.latency_p99_s * 1e3:.1f} ms")
    if rel_err > GOODPUT_TOLERANCE:
        scenario_poisson.failures.append(
            f"poisson goodput {rep.goodput_rps:.2f} rps vs predicted "
            f"{pred:.2f} rps (rel err {rel_err:.1%} > "
            f"{GOODPUT_TOLERANCE:.0%})")
    if rep.arrivals != rep.completed + rep.shed:
        scenario_poisson.failures.append(
            f"poisson lost requests: {rep.arrivals} arrivals != "
            f"{rep.completed} completed + {rep.shed} shed")
    return {"predicted_rps": round(pred, 4), "rel_err": round(rel_err, 4),
            **rep.as_dict()}


scenario_poisson.failures = []


def scenario_bursty(point, quick=True):
    """Bursty-diurnal trace with an SLO: the diurnal peak oversubscribes
    the point, admission control sheds the overflow at the front door."""
    pred = point.throughput_rps
    horizon = 60.0 if quick else 240.0
    slo = max(20.0 * point.bottleneck_s, 2.0 * point.latency_s)
    trace = bursty_diurnal_trace(
        base_rps=0.5 * pred, peak_rps=2.0 * pred, horizon_s=horizon,
        period_s=horizon / 2, seed=1, burst_factor=1.5,
        burst_every_s=horizon / 4, burst_len_s=horizon / 20)
    router = Router(point, slo_s=slo)
    rep = router.serve(trace)
    print(f"  bursty: offered={rep.offered_rps:.2f} rps  "
          f"goodput={rep.goodput_rps:.2f} rps  shed={rep.shed} "
          f"({rep.shed_reasons})  slo={slo * 1e3:.0f} ms  "
          f"violations={rep.slo_violations}")
    if rep.arrivals != rep.completed + rep.shed:
        scenario_bursty.failures.append(
            f"bursty lost requests: {rep.arrivals} arrivals != "
            f"{rep.completed} completed + {rep.shed} shed")
    return {"predicted_rps": round(pred, 4), **rep.as_dict()}


scenario_bursty.failures = []


def scenario_replan(scission, quick=True):
    """Mid-trace re-plan: the controller loses a resource, the listener
    swaps the router's operating point live; nothing in flight drops."""
    ctl = ElasticController(
        scission, MODEL,
        query=Query(objective=THROUGHPUT, batch_sizes=BATCHES,
                    replicas=REPLICAS),
        track_frontier=True)
    point = ctl.current
    router = Router(point, slo_s=None)
    ctl.add_listener(router.on_plan)
    horizon = 40.0 if quick else 120.0
    trace = poisson_trace(rate_rps=1.1 * point.throughput_rps,
                          horizon_s=horizon, seed=2)
    half = horizon / 2
    lost = next(r for r in point.resources if r != "device")
    for a in trace:
        if lost is not None and a.t >= half:
            ctl.on_resource_lost(lost)       # -> router.on_plan -> swap
            lost = None
        router.offer(a)
    router.flush()
    rep = router.report()
    after = ctl.current
    print(f"  replan: lost a resource at t={half:.0f}s  swaps={rep.swaps}  "
          f"{point.throughput_rps:.2f} -> {after.throughput_rps:.2f} rps  "
          f"arrivals={rep.arrivals} completed={rep.completed} "
          f"shed={rep.shed}")
    if rep.swaps < 1:
        scenario_replan.failures.append(
            "replan produced no operating-point swap on the router")
    if rep.arrivals != rep.completed + rep.shed:
        scenario_replan.failures.append(
            f"replan lost requests: {rep.arrivals} arrivals != "
            f"{rep.completed} completed + {rep.shed} shed")
    return {"swaps": rep.swaps,
            "point_before_rps": round(point.throughput_rps, 4),
            "point_after_rps": round(after.throughput_rps, 4),
            **rep.as_dict()}


scenario_replan.failures = []


def smoke(device="cuda"):
    """CI pass: frontier-pick one operating point, serve Poisson + bursty
    traces, re-plan mid-trace; gates goodput-vs-predicted and the
    no-lost-requests invariant."""
    for scenario in (scenario_poisson, scenario_bursty, scenario_replan):
        scenario.failures = []
    s = scission_for("4g", device=device)
    benchmark_cached(s, MODEL, batch_sizes=BATCHES)
    point, res = _frontier_point(s)
    print(f"# frontier point ({MODEL}, 4g): batch={point.batch_size} "
          f"replicas={point.replicas} segments={len(point.segments)} "
          f"predicted={point.throughput_rps:.2f} rps "
          f"(frontier of {len(res.configs)} in {res.query_time_s:.3f}s)")
    out = {
        "model": MODEL, "network": "4g",
        "point": {
            "batch_size": point.batch_size,
            "replicas": list(point.replicas),
            "segments": [(seg.resource, seg.start, seg.end)
                         for seg in point.segments],
            "predicted_rps": round(point.throughput_rps, 4),
            "latency_s": round(point.latency_s, 6),
        },
        "frontier_size": len(res.configs),
        "poisson": scenario_poisson(point, quick=True),
        "bursty": scenario_bursty(point, quick=True),
        "replan": scenario_replan(s, quick=True),
    }
    return out


def failures() -> list[str]:
    """Every gate failure of the scenarios run so far."""
    return (scenario_poisson.failures + scenario_bursty.failures
            + scenario_replan.failures)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="single-model CI pass with the goodput gate")
    ap.add_argument("--out", default=None,
                    help="write the serving report as JSON to this path")
    args = ap.parse_args()
    out = smoke()                 # smoke is currently the only mode
    if args.out is None:
        args.out = "results/bench_serving_torch_smoke.json"
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=2)
    print(f"wrote {args.out}")
    if failures():
        print(f"FAILED serving gates: {'; '.join(failures())}")
        raise SystemExit(1)


if __name__ == "__main__":
    main()
