"""Elastic re-planning — the paper's 'operational change' scenario, automated.

Scission §II-B(vi): when bandwidth shifts, a resource is drained for
maintenance, or a node fails, the deployment must re-partition quickly.
Because benchmark data is cached per (block, resource), re-planning is a
pure query (<50 ms budget) — no re-benchmarking, no re-compile of
unaffected stages.

:class:`ElasticController` watches a resource-membership view and emits a
new :class:`PartitionConfig` whenever the view or the network model changes.
The same mechanism serves fleet-scale elasticity: scaling the 'cloud' tier
from one card to a node of several is just a resource swap (a resource whose
speed factor reflects the larger node) followed by a re-query.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field, replace as _dc_replace
from typing import Callable

from ..core.network import NetworkModel
from ..core.partition import (PartitionConfig, objective_vector,
                              pareto_frontier, trim_replicas)
from ..core.planner import Scission
from ..core.query import Query
from ..core.resources import Resource


@dataclass
class PlanEvent:
    reason: str
    wall_time: float
    plan_time_s: float
    config: PartitionConfig
    # the whole trade-off surface at plan time (controller frontier mode):
    # the Pareto non-dominated set over (latency, throughput, transfer),
    # so operational changes can report how the surface moved, not just
    # which single winner was picked
    frontier: list[PartitionConfig] | None = None

    # both serving metrics are exposed per event so operators can audit the
    # latency/throughput trade-off across re-plans regardless of which
    # objective drove the query
    @property
    def latency_s(self) -> float:
        return self.config.latency_s

    @property
    def throughput_rps(self) -> float:
        return self.config.throughput_rps

    @property
    def operating_point(self) -> tuple[int, tuple[int, ...]]:
        """(batch size, per-stage replicas) the plan was priced at — lets
        operators audit that re-plans preserved the serving operating
        point."""
        return (self.config.batch_size, self.config.replicas)

    @property
    def frontier_size(self) -> int:
        return len(self.frontier or ())


def frontier_shift(before: list[PartitionConfig] | None,
                   after: list[PartitionConfig] | None) -> dict:
    """How the Pareto surface moved between two plans, as objective-vector
    sets ``(latency_s, bottleneck_s, transfer_bytes)``: points ``added`` to
    the frontier, ``removed`` from it, and ``kept`` unchanged.  Vectors are
    exact-comparable across re-plans because every plan prices from the
    same cached benchmark records — only membership changes."""
    bv = {objective_vector(c) for c in (before or ())}
    av = {objective_vector(c) for c in (after or ())}
    return {"added": sorted(av - bv), "removed": sorted(bv - av),
            "kept": sorted(av & bv)}


class ElasticController:
    """Re-plans on membership/network changes, preserving the active
    operating point: every re-plan reuses the controller's query, so its
    batch size and replica budget (and with them the serving engine's
    admission width) survive resource loss, join, and bandwidth shifts.

    With ``track_frontier=True`` every re-plan extracts the Pareto
    frontier over (latency, throughput, transfer) at the new
    membership/network state, stores it on the :class:`PlanEvent`, and
    derives the plan's config **from the frontier** — the objective-best
    point is on the surface by construction (for any non-negative-weight
    objective, a dominated config never scores strictly better than all
    of its dominators), so a frontier-mode re-plan costs a single solve
    instead of a full ``query()`` followed by a full ``frontier()``.
    Unless ``Query.batch_sizes`` is set explicitly, the re-plan sweep is
    pinned to ``Query.batch_size`` so the active operating point is
    preserved across re-plans exactly like the non-frontier mode (the
    derived config's replicas are trimmed to the minimum achieving its
    bottleneck, which leaves the rate unchanged).  An explicit
    ``Query(batch_sizes=...)`` opts into tracking a wider surface, and
    then the derived config is the objective-best point across that sweep
    — its batch may move when a better operating point appears.

    ``warm_start=True`` (default) re-seeds each frontier-mode re-plan
    with the previous surface's still-valid points
    (:meth:`_warm_start_candidates`): points whose resources survived the
    membership change are re-priced against the current engine and merged
    into the new surface.  At ``frontier_epsilon == 0`` the merge cannot
    change the (already exact) result; with ε > 0 it pins previously
    discovered exact points so a re-plan's approximate surface never
    loses coverage on the unchanged part of the space.

    ``incremental=True`` (default, frontier mode only) additionally keeps
    the solver's final **label arrays** (one :class:`LabelState` per
    swept batch size) between re-plans and hands them back to
    :meth:`QueryEngine.frontier_incremental` on the next membership
    change: a departed resource invalidates only the labels whose paths
    touched it (the DP replays its untouched prefix and re-runs from the
    first affected block), a joined resource generates only the delta
    paths that visit it.  Labels price link costs, so a network change
    drops the kept states and re-plans cold; every unsound-reuse case
    falls back to a cold solve inside the engine, keeping re-plans exact.
    """

    def __init__(self, scission: Scission, model: str,
                 input_bytes: float = 150e3, query: Query | None = None,
                 graph=None, track_frontier: bool = False,
                 warm_start: bool = True, incremental: bool = True):
        self.scission = scission
        self.model = model
        self.input_bytes = input_bytes
        self.query = query or Query(top_n=1)
        self.graph = graph            # for incremental benchmarking on join
        self.track_frontier = track_frontier
        self.warm_start = warm_start
        self.incremental = incremental
        # per-batch final label arrays of the last frontier-mode re-plan;
        # valid across membership changes only (network changes clear it)
        self._label_states: dict = {}
        self.history: list[PlanEvent] = []
        self._listeners: list = []
        self._replan("initial")

    def add_listener(self, fn) -> None:
        """Register a callable invoked with every :class:`PlanEvent` this
        controller produces from now on (e.g. a serving
        :meth:`on_plan` of a serving router, which swaps its
        operating point live when the plan changes).  Listeners do not see
        plans that predate registration — push ``controller.current``
        yourself if the subscriber needs the standing plan."""
        self._listeners.append(fn)

    @property
    def current(self) -> PartitionConfig:
        return self.history[-1].config

    def _last_frontier(self) -> list[PartitionConfig] | None:
        for ev in reversed(self.history):
            if ev.frontier is not None:
                return ev.frontier
        return None

    def _warm_start_candidates(self, prev: list[PartitionConfig]
                               ) -> list[PartitionConfig]:
        """Previous-frontier points that remain valid under the current
        membership and constraints, re-priced against the current engine
        (bandwidth may have shifted, so costs are recomputed; only the
        *shape* — segments, batch size — is reused)."""
        eng = self.scission.engine(self.model, self.input_bytes)
        cons = self.query.constraints()
        names = {r.name for r in self.scission.resources}
        out: list[PartitionConfig] = []
        for cfg in prev:
            if not set(cfg.resources) <= names:
                continue              # a member resource left the fleet
            try:
                cost = eng._cost_for(
                    _dc_replace(self.query, batch_size=cfg.batch_size))
            except ValueError:
                continue              # batch no longer measurable
            cfg2 = cost.evaluate(cfg.segments)
            if eng._config_satisfies(cfg2, cons, cost):
                out.append(trim_replicas(cfg2))
        return out

    def _replan(self, reason: str) -> PlanEvent:
        t0 = time.perf_counter()
        if self.track_frontier:
            # one solve: the frontier carries the objective-best point, so
            # no separate query() pass is needed.  Pin the sweep to the
            # query's batch size (unless the caller asked for a wider one)
            # so the active operating point survives re-plans.
            fq = self.query if self.query.batch_sizes is not None else \
                _dc_replace(self.query,
                            batch_sizes=(self.query.batch_size,))
            prev = self._last_frontier() if self.warm_start else None
            if self.incremental:
                # labels price link latency/bandwidth, so only membership
                # changes may reuse them — a network change solves cold
                eng = self.scission.engine(self.model, self.input_bytes)
                held = None if reason == "network-change" \
                    else self._label_states
                res, self._label_states = eng.frontier_incremental(fq, held)
                front = res.configs
            else:
                front = self.scission.frontier(self.model, fq,
                                               self.input_bytes).configs
            if prev:
                merged = {(c.segments, c.batch_size, c.replicas): c
                          for c in (*front,
                                    *self._warm_start_candidates(prev))}
                front = pareto_frontier(list(merged.values()))
                front.sort(key=lambda c: (c.latency_s, c.bottleneck_s,
                                          c.transfer_bytes))
            if not front:
                raise ValueError(
                    f"re-plan ({reason}) found no feasible configuration "
                    f"for model {self.model!r} under the current "
                    "membership and constraints")
            score = self.query.objective.score
            config = min(front, key=lambda c: (score(c),
                                               objective_vector(c)))
        else:
            res = self.scission.query(self.model, self.query,
                                      self.input_bytes)
            front = None
            config = res.best
        ev = PlanEvent(reason=reason, wall_time=time.time(),
                       plan_time_s=time.perf_counter() - t0,
                       config=config, frontier=front)
        self.history.append(ev)
        for fn in self._listeners:
            fn(ev)
        return ev

    def last_frontier_shift(self) -> dict | None:
        """Frontier movement between the two most recent frontier-carrying
        plans (None until two such plans exist — requires frontier mode)."""
        evs = [e for e in self.history if e.frontier is not None]
        if len(evs) < 2:
            return None
        return frontier_shift(evs[-2].frontier, evs[-1].frontier)

    # -- operational changes --------------------------------------------------
    def on_resource_lost(self, name: str) -> PlanEvent:
        """Node failure / maintenance drain: drop the resource, re-query.

        The query — and with it the active operating point (batch size and
        replica budget) — is preserved untouched.  A budget entry for the
        lost resource is inert while it is gone (only resources that appear
        in a plan's segments are consulted) and becomes active again if the
        resource rejoins, so a lose/rejoin cycle restores the original
        operating point.
        """
        remaining = [r for r in self.scission.resources if r.name != name]
        self.scission = self.scission.with_resources(remaining)
        return self._replan(f"lost:{name}")

    def on_resource_joined(self, resource: Resource) -> PlanEvent:
        """Elastic scale-up: Scission Step 3 runs incrementally for the new
        resource only (existing records are reused), then a re-query.

        Fails fast — *before* mutating the membership view — when the new
        resource has no benchmark records and no graph is available for
        incremental benchmarking; admitting it would make the very next
        re-plan die inside ``times_matrix``.
        """
        db = self.scission._dbs.get(self.model)
        if self.graph is None and \
                (db is None or resource.name not in db.records):
            raise ValueError(
                f"cannot admit resource {resource.name!r}: model "
                f"{self.model!r} has no benchmark records for it and the "
                "controller was built without graph=..., so incremental "
                "benchmarking is impossible.  Pass graph= at construction "
                "or call Scission.benchmark_resource() before joining.")
        # benchmark BEFORE mutating membership so a provider failure
        # (compile error, OOM on the new resource) leaves the controller
        # in a consistent, re-plannable state
        if self.graph is not None:
            self.scission.benchmark_resource(self.graph, resource)
        self.scission.resources = [*self.scission.resources, resource]
        self.scission._engines.clear()
        return self._replan(f"joined:{resource.name}")

    def on_network_change(self, network: NetworkModel) -> PlanEvent:
        """Bandwidth shift (the drone-leaves-low-coverage case)."""
        old = self.scission
        self.scission = Scission(
            resources=old.resources, network=network, source=old.source,
            provider=old.provider, runs=old.runs, device=old.device)
        # carry cached benchmark DBs — they are network-independent
        for db in old._dbs.values():
            self.scission.load(db)
        return self._replan("network-change")
