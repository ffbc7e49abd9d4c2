"""Figures 6-15 + Table IV in the port: Scission decisions under network
conditions, input sizes, constraints, pipelines, and top-N rankings — plus
the beyond-paper pipelined-serving scenarios: throughput-optimal partitions
(predicted vs. simulated), Pareto-front queries, and batched/replicated
operating points — over BenchmarkDBs of the zoo timed on ``device`` (the
card unless the caller passes another).

Run standalone in smoke mode::

    PYTHONPATH=src python -m benchmarks.bench_partitions_torch --smoke \
        --out results/bench_partitions_torch_smoke.json

    # batched/replicated path (two batch sizes, replicated stages); fails
    # if predicted vs simulated throughput diverges by more than 25%:
    PYTHONPATH=src python -m benchmarks.bench_partitions_torch \
        --smoke-batched

    # frontier exactness + scaling + incremental re-plans: fails unless the
    # ParetoLattice frontier equals the exhaustive frontier on the paper
    # networks x operating points (also under binding path-dependent
    # constraints), the fleet-sized frontier query stays interactive and
    # warm re-plans equal cold solves:
    PYTHONPATH=src python -m benchmarks.bench_partitions_torch \
        --smoke-frontier

    # lattice vs exhaustive oracle solve times (the chain frontier):
    PYTHONPATH=src python -m benchmarks.bench_partitions_torch --perf-gate

The reference's DAG-general scenario (``scenario_dag``, its ``--smoke-dag``
mode, and the DAG half of ``perf_gate``) partitions a MoE layer and an
enc-dec LM built by ``models/graph_adapter.py``; the port has neither the
LM models nor the adapter yet, so those are not run here, and ``run`` and
``perf_gate`` say so where they would run them.
"""

from __future__ import annotations

import argparse
import json
import os
import time

from repro_torch.core import Query, THROUGHPUT
from repro_torch.core import objective_vector as _vec
from repro_torch.serving.sim import simulate_pipeline_throughput

from .common_torch import benchmark_cached, fleet_engine, scission_for


def _scission(net, device):
    """One Scission per (network, device), shared by the scenarios so a
    model's DB is timed once per network."""
    key = (net, str(device))
    if key not in _SCISSIONS:
        _SCISSIONS[key] = scission_for(net, device=device)
    return _SCISSIONS[key]


_SCISSIONS: dict = {}


def _best(scission, model, query=None, input_bytes=150e3):
    res = scission.query(model, query or Query(top_n=1), input_bytes)
    return res.best, res.query_time_s


def scenario_network(quick=True, device="cuda"):
    """Figs 6-8: optimal partition vs network condition."""
    print("\n# Figs 6-8 — lowest-latency partition per network condition")
    rows = []
    models = ["VGG19", "ResNet50", "MobileNetV2"] if not quick else \
        ["ResNet50", "MobileNetV2"]
    for net in ("3g", "4g", "wired"):
        s = _scission(net, device)
        for m in models:
            benchmark_cached(s, m)
            best, qt = _best(s, m)
            print(f"  [{net}] {best.describe()}")
            rows.append((f"net/{net}/{m}", qt * 1e6,
                         round(best.latency_s, 4)))
    return rows



def scenario_input_size(quick=True, device="cuda"):
    """Fig 9: partition sensitivity to input size (3G).  The paper's flip
    happens at 170KB on its testbed; we report the flip threshold on ours
    (the exact value depends on tier speeds — the sensitivity is the
    claim)."""
    print("\n# Fig 9 — input size sensitivity (ResNet50, 3G)")
    s = _scission("3g", device)
    benchmark_cached(s, "ResNet50")
    rows = []
    for kb in (150, 170, 220, 300):
        best, qt = _best(s, "ResNet50", input_bytes=kb * 1e3)
        print(f"  [{kb}KB] {best.describe()}")
        rows.append((f"input/{kb}kb", qt * 1e6, round(best.latency_s, 4)))
    return rows


def scenario_constraints(quick=True, device="cuda"):
    """Figs 10-11: entire resource pipeline must be used."""
    print("\n# Figs 10-11 — constraint: device+edge+cloud must all be used")
    rows = []
    q = Query(top_n=1, must_use=("device", "edge1", "cloud_gpu"))
    models = ["VGG19", "ResNet50"] if not quick else ["ResNet50"]
    for net in ("3g", "4g"):
        s = _scission(net, device)
        for m in models:
            benchmark_cached(s, m)
            best, qt = _best(s, m, q)
            print(f"  [{net}] {best.describe()}")
            rows.append((f"cons/{net}/{m}", qt * 1e6,
                         round(best.latency_s, 4)))
    return rows


def scenario_pipelines(quick=True, device="cuda"):
    """Figs 12-14: Edge(1) vs Edge(2) hardware sensitivity (wired)."""
    print("\n# Figs 12-14 — edge hardware sensitivity (wired)")
    rows = []
    s = _scission("wired", device)
    models = ["InceptionV3", "DenseNet169"] if not quick else \
        ["InceptionV3"]
    for m in models:
        benchmark_cached(s, m)
        for edge in ("edge1", "edge2"):
            other = "edge2" if edge == "edge1" else "edge1"
            q = Query(top_n=1, must_use=(edge,), exclude=(other,))
            best, qt = _best(s, m, q)
            print(f"  [{edge}] {best.describe()}")
            rows.append((f"pipe/{edge}/{m}", qt * 1e6,
                         round(best.latency_s, 4)))
    return rows


def scenario_topn(quick=True, device="cuda"):
    """Table IV + Fig 15: top-3 per distributed pipeline (ResNet50)."""
    print("\n# Table IV — top-3 partitions per pipeline (ResNet50, wired)")
    s = _scission("wired", device)
    benchmark_cached(s, "ResNet50")
    pipelines = {
        "device-edge": (("device", "edge1"),),
        "device-cloud": (("device", "cloud_gpu"),),
        "edge-cloud": (("edge1", "cloud_gpu"),),
        "device-edge-cloud": (("device", "edge1", "cloud_gpu"),),
    }
    rows = []
    for name, pipes in pipelines.items():
        res = s.query("ResNet50", Query(top_n=3, pipelines=pipes))
        print(f"  [{name}]")
        for cfg in res.configs:
            print(f"    {cfg.describe()}")
        if res.configs:
            rows.append((f"topn/{name}", res.query_time_s * 1e6,
                         round(res.configs[0].latency_s, 4)))
    return rows


def scenario_throughput(quick=True, models=None, device="cuda"):
    """Beyond-paper: throughput-optimal partition per network condition,
    with the cost-model prediction validated against a pipelined-serving
    simulation (steady-state rate of the bottleneck stage).  Validation
    failures accumulate in ``scenario_throughput.failures`` so smoke mode
    can turn them into a non-zero exit code."""
    print("\n# Pipelined serving — predicted vs simulated throughput")
    scenario_throughput.failures = []
    rows = []
    models = models or (["ResNet50", "MobileNetV2"] if quick else
                        ["VGG19", "ResNet50", "MobileNetV2"])
    for net in ("3g", "4g", "wired"):
        s = _scission(net, device)
        for m in models:
            benchmark_cached(s, m)
            res = s.query(m, Query(top_n=1, objective=THROUGHPUT))
            best = res.best
            pred = best.throughput_rps
            t0 = time.perf_counter()
            sim = simulate_pipeline_throughput(best, n_requests=256)
            sim_us = (time.perf_counter() - t0) * 1e6
            err = abs(sim - pred) / pred if pred > 0 else 0.0
            ok = "PASS" if err < 0.02 else "FAIL"
            if ok == "FAIL":
                scenario_throughput.failures.append(f"{net}/{m}")
            print(f"  [{net}] {m}: pred={pred:8.2f}rps sim={sim:8.2f}rps "
                  f"err={err * 100:.2f}% {ok}  {best.describe()}")
            rows.append((f"thpt/{net}/{m}", res.query_time_s * 1e6,
                         round(pred, 3)))
            rows.append((f"thpt_sim/{net}/{m}", sim_us, round(sim, 3)))
    return rows


scenario_throughput.failures = []


def scenario_frontier(quick=True, models=None, device="cuda"):
    """Beyond-paper: Pareto front over (latency, throughput, transfer) —
    the operating points a deployment actually chooses between."""
    print("\n# Pareto frontier — (latency, throughput, transfer)")
    rows = []
    models = models or ["ResNet50"]
    for net in ("3g", "wired") if quick else ("3g", "4g", "wired"):
        s = _scission(net, device)
        for m in models:
            benchmark_cached(s, m)
            res = s.frontier(m)
            print(f"  [{net}] {m}: {len(res.configs)} non-dominated configs "
                  f"({res.strategy}, {res.query_time_s * 1e3:.1f}ms)")
            for cfg in res.configs[:3]:
                print(f"    {cfg.describe()}")
            rows.append((f"front/{net}/{m}", res.query_time_s * 1e6,
                         len(res.configs)))
    return rows


def _frontiers_match(a, b, rtol=1e-9):
    """Vector-set equality of two frontiers (objective vectors matched
    within ``rtol``, both directions)."""
    va = sorted({_vec(c) for c in a})
    vb = sorted({_vec(c) for c in b})
    if len(va) != len(vb):
        return False
    return all(all(abs(x - y) <= rtol * max(abs(x), abs(y), 1e-30)
                   for x, y in zip(p, q)) for p, q in zip(va, vb))


def scenario_frontier_exact(quick=True, models=None, batch_sizes=(1, 4),
                            replicas=None, device="cuda"):
    """Frontier exactness: the ParetoLattice strategy must return the same
    objective-vector set as the exhaustive oracle — across 3G/4G/wired,
    operating points (measured batches × a replica budget), a must-use
    constraint, and overlapping restricted pipelines.  Mismatches
    accumulate in ``scenario_frontier_exact.failures`` so smoke mode turns
    them into a non-zero exit code."""
    print("\n# Frontier exactness — ParetoLattice vs exhaustive oracle")
    scenario_frontier_exact.failures = []
    rows = []
    models = models or ["MobileNetV2"]
    replicas = replicas if replicas is not None else \
        {"device": 2, "edge1": 2}
    queries = {
        "free": Query(batch_sizes=tuple(batch_sizes), replicas=replicas),
        "must": Query(batch_sizes=tuple(batch_sizes), replicas=replicas,
                      must_use=("device", "edge1", "cloud_gpu")),
        "pipes": Query(batch_sizes=tuple(batch_sizes), replicas=replicas,
                       pipelines=(("device", "edge1"),
                                  ("device", "edge1", "cloud_gpu"),
                                  ("device", "cloud_gpu"))),
    }
    for net in ("3g", "4g", "wired"):
        s = _scission(net, device)
        for m in models:
            benchmark_cached(s, m, batch_sizes=batch_sizes)
            for qname, q in queries.items():
                exh = s.frontier(m, q, strategy="exhaustive")
                lat = s.frontier(m, q, strategy="lattice")
                auto = s.frontier(m, q)
                equal = _frontiers_match(exh.configs, lat.configs)
                # auto-dispatch must have picked the faster of the two
                # forced strategies on this (space, constraints) point
                forced = {"exhaustive": exh, "lattice": lat}
                fastest = min(forced, key=lambda k: forced[k].query_time_s)
                ok = "PASS" if equal else "FAIL"
                if not equal:
                    scenario_frontier_exact.failures.append(
                        f"{net}/{m}/{qname}")
                print(f"  [{net}] {m}/{qname}: front={len(exh.configs)} "
                      f"exh={exh.query_time_s * 1e3:.1f}ms "
                      f"lat={lat.query_time_s * 1e3:.1f}ms "
                      f"auto={auto.strategy}"
                      f"({auto.query_time_s * 1e3:.1f}ms, forced-best "
                      f"{fastest}) "
                      f"labels={lat.labels_kept}+{lat.labels_pruned} {ok}")
                rows.append((f"front_exact/{net}/{m}/{qname}",
                             lat.query_time_s * 1e6, len(lat.configs)))
                rows.append((f"front_exact_oracle/{net}/{m}/{qname}",
                             exh.query_time_s * 1e6, len(exh.configs)))
                rows.append((f"front_auto/{net}/{m}/{qname}",
                             auto.query_time_s * 1e6, auto.strategy))
                rows.append((f"front_labels/{net}/{m}/{qname}",
                             float(lat.labels_kept),
                             int(lat.labels_pruned)))
    return rows


scenario_frontier_exact.failures = []


def scenario_frontier_constrained(quick=True, models=None,
                                  device="cuda"):
    """Binding path-dependent constraints (max_resource_time /
    min_blocks_on) folded into the lattice DP state: every lattice
    strategy must return exactly the exhaustive oracle's result set — no
    under-filled or empty results while a feasible config exists.  The
    caps are derived per (network, model) from the unconstrained winner
    (half its heaviest per-resource compute time), so the 'tmax' scenarios
    are binding by construction: the unconstrained winner itself is
    infeasible under them."""
    print("\n# Constraint exactness — binding path-dependent constraints")
    scenario_frontier_constrained.failures = []
    rows = []
    models = models or ["MobileNetV2"]
    for net in ("3g", "4g", "wired"):
        s = _scission(net, device)
        for m in models:
            benchmark_cached(s, m)
            n_blocks = s._dbs[m].n_blocks
            base = s.query(m, Query(top_n=1)).best
            res_heavy, t_heavy = max(base.compute_s.items(),
                                     key=lambda kv: kv[1])
            floor = {"device": max(2, n_blocks // 3)}
            queries = {
                "tmax": Query(max_resource_time={res_heavy: t_heavy / 2}),
                "nmin": Query(min_blocks_on=floor),
                "both": Query(max_resource_time={res_heavy: t_heavy / 2},
                              min_blocks_on=floor),
            }
            for qname, q in queries.items():
                exh = s.frontier(m, q, strategy="exhaustive")
                lat = s.frontier(m, q, strategy="lattice")
                equal = _frontiers_match(exh.configs, lat.configs)
                underfill = bool(exh.configs) and not lat.configs
                ok = "PASS" if equal and not underfill else "FAIL"
                if ok == "FAIL":
                    scenario_frontier_constrained.failures.append(
                        f"{net}/{m}/{qname}")
                print(f"  [{net}] {m}/{qname}: front={len(exh.configs)} "
                      f"exh={exh.query_time_s * 1e3:.1f}ms "
                      f"lat={lat.query_time_s * 1e3:.1f}ms "
                      f"labels={lat.labels_kept}+{lat.labels_pruned} {ok}")
                rows.append((f"front_cons/{net}/{m}/{qname}",
                             lat.query_time_s * 1e6, len(lat.configs)))
                rows.append((f"front_cons_oracle/{net}/{m}/{qname}",
                             exh.query_time_s * 1e6, len(exh.configs)))
                rows.append((f"front_cons_labels/{net}/{m}/{qname}",
                             float(lat.labels_kept),
                             int(lat.labels_pruned)))
    return rows


scenario_frontier_constrained.failures = []

# fleet-sized frontier queries must stay interactive; the measured path is
# ~0.5 s on a 27-resource / 32-block fleet (~350k-config space), so 5 s is
# a generous regression tripwire rather than a tight bound
FLEET_FRONTIER_BUDGET_S = 5.0


def scenario_frontier_scale(quick=True, n_per_tier=9, n_blocks=32):
    """Frontier query-time scaling on a fleet-sized resource set (search
    space beyond EXHAUSTIVE_LIMIT, where only the lattice strategy is
    viable), with label-set statistics and the ε-dominance knob."""
    print("\n# Frontier scaling — fleet-sized space (lattice only)")
    scenario_frontier_scale.failures = []
    rows = []
    eng = fleet_engine(n_per_tier=n_per_tier, n_blocks=n_blocks)
    space = eng._search_space()
    n_res = len(eng.resources)
    print(f"  fleet: {n_res} resources x {eng.db.n_blocks} blocks, "
          f"search space {space} configs")
    rows.append(("front_scale/space", 0.0, space))
    import repro_torch.core.query as query_mod
    assert space > query_mod.EXHAUSTIVE_LIMIT, \
        "fleet scenario must exceed the exhaustive limit"
    for eps in ((0.0, 0.05) if quick else (0.0, 0.01, 0.05)):
        res = eng.frontier(Query(frontier_epsilon=eps))
        ok = "PASS" if res.query_time_s < FLEET_FRONTIER_BUDGET_S else "FAIL"
        if ok == "FAIL":
            scenario_frontier_scale.failures.append(
                f"fleet/eps={eps}: {res.query_time_s:.2f}s "
                f"> {FLEET_FRONTIER_BUDGET_S}s")
        print(f"  [eps={eps}] {res.query_time_s * 1e3:.0f}ms "
              f"front={len(res.configs)} labels_kept={res.labels_kept} "
              f"labels_pruned={res.labels_pruned} ({res.strategy}) {ok}")
        rows.append((f"front_scale/eps{eps}", res.query_time_s * 1e6,
                     len(res.configs)))
        rows.append((f"front_scale_labels/eps{eps}",
                     float(res.labels_kept), int(res.labels_pruned)))
    return rows


scenario_frontier_scale.failures = []


def scenario_batched(quick=True, models=None, batch_sizes=(1, 4),
                     replicas=None, device="cuda"):
    """Beyond-paper: batched + replicated operating points.  Benchmarks a
    per-batch profile, compares the best batch-1 single-replica throughput
    partition against the frontier's best (batch, replica) operating point,
    and validates the winner's prediction against the replica-aware
    pipeline simulation.

    A point FAILS when predicted vs simulated diverges by more than 25%
    (wall-clock batch profiles are noisier than the batch-1 path); the
    whole scenario additionally fails unless at least one (network, model)
    shows a batched/replicated point beating its batch-1 baseline.
    """
    print("\n# Batched/replicated operating points — frontier vs batch-1")
    scenario_batched.failures = []
    rows = []
    models = models or ["MobileNetV2"]
    replicas = replicas if replicas is not None else \
        {"device": 2, "edge1": 2}
    rep_desc = ",".join(f"{k}x{v}" for k, v in sorted(replicas.items()))
    gains = []
    for net in ("3g", "wired") if quick else ("3g", "4g", "wired"):
        s = _scission(net, device)
        for m in models:
            benchmark_cached(s, m, batch_sizes=batch_sizes)
            base = s.query(m, Query(top_n=1, objective=THROUGHPUT)).best
            res = s.frontier(m, Query(batch_sizes=tuple(batch_sizes),
                                      replicas=replicas))
            top = max(res.configs, key=lambda c: c.throughput_rps)
            pred = top.throughput_rps
            t0 = time.perf_counter()
            sim = simulate_pipeline_throughput(top, n_requests=512)
            sim_us = (time.perf_counter() - t0) * 1e6
            err = abs(sim - pred) / pred if pred > 0 else 0.0
            gain = pred / base.throughput_rps if base.throughput_rps else 1.0
            gains.append(gain)
            ok = "PASS" if err < 0.25 else "FAIL"
            if ok == "FAIL":
                scenario_batched.failures.append(f"{net}/{m}")
            print(f"  [{net}] {m} (batches={list(batch_sizes)} "
                  f"budget={rep_desc}):")
            print(f"    batch-1 best : {base.describe()}")
            print(f"    frontier best: {top.describe()}")
            print(f"    pred={pred:8.2f}rps sim={sim:8.2f}rps "
                  f"err={err * 100:.2f}% gain={gain:.2f}x {ok}")
            rows.append((f"batched/{net}/{m}", res.query_time_s * 1e6,
                         round(pred, 3)))
            rows.append((f"batched_sim/{net}/{m}", sim_us, round(sim, 3)))
            rows.append((f"batched_gain/{net}/{m}", 0.0, round(gain, 3)))
    if gains and max(gains) <= 1.0:
        scenario_batched.failures.append(
            "no-gain: no batched/replicated point beat its batch-1 baseline")
    return rows


scenario_batched.failures = []


def scenario_replan(quick=True, reps=7, device="cuda"):
    """Incremental elastic re-plans: ``QueryEngine.frontier_incremental``
    keeps each operating point's final label arrays and warm-starts the
    next re-plan from them.  Gates on (i) warm re-plans returning configs
    identical to cold solves in every scenario, and (ii) label reuse being
    demonstrable — warm re-solve < 50% of the cold solve time — both for a
    steady-state re-plan (unchanged membership) and for the loss of a
    link-budget-barred resource (its labels only enter the DP once
    activations fit the link budget, so the clean prefix is replayed and
    the DP re-runs only from the first affected block)."""
    import numpy as np

    from repro_torch.core import Query as _Q

    print("\n# Incremental elastic re-plans — label reuse vs cold solves")
    scenario_replan.failures = []
    rows = []
    s = _scission("4g", device)
    benchmark_cached(s, "MobileNetV2")
    eng = s.engine("MobileNetV2", 150e3)

    def _key(cfgs):
        return [(c.segments, c.batch_size, c.replicas) for c in cfgs]

    def _pair(eng2, q, states, label):
        cold = warm = float("inf")
        rc = rw = None
        for _ in range(reps):
            c, _ = eng2.frontier_incremental(q, None)
            cold = min(cold, c.solve_seconds)
            rc = c
            w, _ = eng2.frontier_incremental(q, states)
            warm = min(warm, w.solve_seconds)
            rw = w
        same = _key(rc.configs) == _key(rw.configs)
        ratio = warm / cold
        if not same:
            scenario_replan.failures.append(f"replan-mismatch/{label}")
        print(f"  {label:12s} cold={cold * 1e6:7.0f}us "
              f"warm={warm * 1e6:7.0f}us ratio={ratio:.3f} "
              f"{'PASS' if same else 'FAIL'}")
        return cold, warm, ratio

    # steady-state re-plan: membership unchanged, the kept labels replay
    # end to end (the controller's common case after any event settles)
    q = _Q()
    res, states = eng.frontier_incremental(q)
    cold, warm, ratio = _pair(eng, q, states, "steady")
    rows.append(("front_replan/cold", cold * 1e6, len(res.configs)))
    rows.append(("front_replan/steady", warm * 1e6, round(ratio, 3)))
    if ratio >= 0.5:
        scenario_replan.failures.append(
            f"replan-slow/steady ratio={ratio:.3f} (>= 0.5)")

    # membership loss of a link-barred resource: cloud_gpu only admits
    # hand-offs once activations fit the link budget, so most blocks never
    # saw a cloud_gpu label and their label arrays replay verbatim
    ob = np.asarray(eng.cost.out_bytes, dtype=float)
    lim = float(np.percentile(ob, 5))
    others = [r.name for r in s.resources if r.name != "cloud_gpu"]
    qb = _Q(max_link_bytes={(o, "cloud_gpu"): lim for o in others})
    _, states_b = eng.frontier_incremental(qb)
    s_drop = s.with_resources(
        [r for r in s.resources if r.name != "cloud_gpu"])
    eng_drop = s_drop.engine("MobileNetV2", 150e3)
    _, warm_d, ratio_d = _pair(eng_drop, qb, states_b, "drop-barred")
    rows.append(("front_replan/drop_barred", warm_d * 1e6,
                 round(ratio_d, 3)))
    if ratio_d >= 0.5:
        scenario_replan.failures.append(
            f"replan-slow/drop_barred ratio={ratio_d:.3f} (>= 0.5)")

    # resource join: the extend path generates only delta paths that visit
    # the newcomer; exactness is the gate (the delta spans most of this
    # small space, so no speedup is claimed)
    from repro_torch.core import Resource as _R
    from repro_torch.core.resources import EDGE_BOX_2 as _E2
    from repro_torch.models import cnn_zoo as _zoo
    r_new = _R("edge3", "edge", _E2, speed_factor=2.0)
    s.benchmark_resource(_zoo.build("MobileNetV2", s.device), r_new)
    s_join = s.with_resources([*s.resources, r_new])
    eng_join = s_join.engine("MobileNetV2", 150e3)
    _, warm_j, ratio_j = _pair(eng_join, q, states, "join")
    rows.append(("front_replan/join", warm_j * 1e6, round(ratio_j, 3)))
    return rows


scenario_replan.failures = []


DAG_WAITS = ("the DAG-general scenario waits for the LM models and "
             "models/graph_adapter.py, whose MoE layer and enc-dec LM it "
             "partitions: not run")


def perf_gate(reps=7, threshold=1.5, device="cuda"):
    """Exact-solver performance gate: the chain frontier lattice must
    answer within ``threshold``x of the exhaustive oracle's pure solve
    time (min-of-``reps`` of ``QueryResult.solve_seconds``, both strategies
    warm — each keeps its natural caches after one cold priming call; the
    machine is too noisy for mean-of-reps to gate on) on MobileNetV2 under
    3G, 4G and wired.  The reference also gates the SP solve and frontier
    on its DAG graphs; those wait with ``scenario_dag``."""
    print(f"\n# Perf gate — lattice vs exhaustive oracle "
          f"(min of {reps}, fail > {threshold}x)")
    perf_gate.failures = []
    rows = []

    def _gate(name, t_lat, t_orc):
        ratio = t_lat / t_orc
        rows.append((f"gate/{name}", t_lat * 1e6, round(ratio, 3)))
        ok = ratio <= threshold
        if not ok:
            perf_gate.failures.append(f"{name} ratio={ratio:.2f}")
        print(f"  {name:34s} {t_lat * 1e6:7.0f}us vs {t_orc * 1e6:7.0f}us "
              f"= {ratio:5.2f}x {'PASS' if ok else 'FAIL'}")

    print(f"  dag_sp, front_dag: {DAG_WAITS}")
    for net in ("3g", "4g", "wired"):
        s = scission_for(net, device=device)
        benchmark_cached(s, "MobileNetV2")
        eng = s.engine("MobileNetV2", 150e3)
        fl = fe = float("inf")
        eng.frontier(strategy="lattice")
        eng.frontier(strategy="exhaustive")
        for _ in range(reps):
            fl = min(fl, eng.frontier(strategy="lattice").solve_seconds)
            fe = min(fe, eng.frontier(strategy="exhaustive").solve_seconds)
        _gate(f"front_chain/{net}/MobileNetV2", fl, fe)
    return rows


perf_gate.failures = []


def failures() -> list[str]:
    """Every gate failure of the scenarios run so far."""
    return (scenario_throughput.failures + scenario_batched.failures
            + scenario_frontier_exact.failures
            + scenario_frontier_constrained.failures
            + scenario_frontier_scale.failures
            + scenario_replan.failures + perf_gate.failures)


def run(quick: bool = True, device: str = "cuda"):
    rows = []
    rows += scenario_network(quick, device=device)
    rows += scenario_input_size(quick, device=device)
    rows += scenario_constraints(quick, device=device)
    rows += scenario_pipelines(quick, device=device)
    rows += scenario_topn(quick, device=device)
    rows += scenario_throughput(quick, device=device)
    rows += scenario_frontier(quick, device=device)
    rows += scenario_batched(quick, device=device)
    rows += scenario_frontier_exact(quick, device=device)
    rows += scenario_frontier_constrained(quick, device=device)
    rows += scenario_frontier_scale(quick)
    print(f"\n# DAG-general partitioning: {DAG_WAITS}")
    return rows


def smoke_batched(device="cuda"):
    """CI pass for the batched/replicated path: one CNN, two batch sizes,
    a two-replica budget on the device and edge tiers, 3G + wired."""
    return scenario_batched(quick=True, models=["MobileNetV2"],
                            batch_sizes=(1, 4),
                            replicas={"device": 2, "edge1": 2},
                            device=device)


def smoke_frontier(device="cuda"):
    """CI pass for frontier exactness + scaling: gates on lattice-vs-
    exhaustive frontier vector-set equality (paper-network spaces across
    3G/4G/wired and operating points), on constraint exactness under
    binding path-dependent constraints (max_resource_time /
    min_blocks_on — no under-filled or empty lattice results while a
    feasible config exists), on the fleet-sized frontier staying
    interactive, with label statistics in the JSON artifact, and on warm
    incremental re-plans equal to cold solves."""
    rows = scenario_frontier_exact(quick=True, models=["MobileNetV2"],
                                   batch_sizes=(1, 4),
                                   replicas={"device": 2, "edge1": 2},
                                   device=device)
    rows += scenario_frontier_constrained(quick=True,
                                          models=["MobileNetV2"],
                                          device=device)
    rows += scenario_frontier_scale(quick=True)
    rows += scenario_replan(quick=True, device=device)
    return rows


def smoke(device="cuda"):
    """Minimal single-model pass for CI: one CNN, all three network
    conditions, exercising the latency, throughput and frontier query
    paths.  Returns JSON-serialisable rows."""
    rows = []
    rows += scenario_throughput(quick=True, models=["MobileNetV2"],
                                device=device)
    rows += scenario_frontier(quick=True, models=["MobileNetV2"],
                              device=device)
    s = _scission("wired", device)
    benchmark_cached(s, "MobileNetV2")
    best, qt = _best(s, "MobileNetV2")
    rows.append(("smoke/latency/MobileNetV2", qt * 1e6,
                 round(best.latency_s, 4)))
    return rows


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="single-model CI pass (fastest)")
    ap.add_argument("--smoke-batched", action="store_true",
                    help="single-model CI pass over the batched/replicated "
                         "path (two batch sizes, replicated stages)")
    ap.add_argument("--smoke-frontier", action="store_true",
                    help="CI pass gated on lattice-vs-exhaustive frontier "
                         "equality plus fleet-sized query-time scaling")
    ap.add_argument("--perf-gate", action="store_true",
                    help="performance gate: the chain frontier lattice "
                         "must answer within 1.5x of the exhaustive oracle "
                         "(warm-vs-warm, min of 7 reps)")
    ap.add_argument("--full", action="store_true", help="all models")
    ap.add_argument("--out", default=None,
                    help="write rows as JSON to this path (smoke modes "
                         "default to "
                         "results/bench_partitions_torch_<mode>.json)")
    args = ap.parse_args()
    if args.smoke_batched:
        rows, mode = smoke_batched(), "smoke_batched"
    elif args.smoke_frontier:
        rows, mode = smoke_frontier(), "smoke_frontier"
    elif args.smoke:
        rows, mode = smoke(), "smoke"
    elif args.perf_gate:
        rows, mode = perf_gate(), "perf_gate"
    else:
        rows, mode = run(quick=not args.full), None
    if args.out is None and mode is not None:
        args.out = f"results/bench_partitions_torch_{mode}.json"
    print("\nname,us_per_call,derived")
    for name, us, derived in rows:
        print(f"{name},{us:.1f},{derived}")
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump([{"name": n, "us_per_call": us, "derived": d}
                       for n, us, d in rows], f, indent=2)
        print(f"wrote {args.out}")
    if failures():
        print(f"FAILED validation (throughput / frontier exactness / "
              f"frontier scaling / incremental re-plan / perf gate): "
              f"{', '.join(failures())}")
        raise SystemExit(1)


if __name__ == "__main__":
    main()
