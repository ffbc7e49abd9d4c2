"""Query engine (Scission §II-C Step 6).

Queries run against a cached :class:`BenchmarkDB` — never against live
hardware — which is what keeps the paper's "<50 ms per query" budget.  Two
execution strategies, chosen automatically:

* small search spaces (≤ ``EXHAUSTIVE_LIMIT`` configs): vectorised
  exhaustive enumeration + filter (the paper's own strategy);
* large spaces: the k-best :class:`PartitionLattice` — or, for the
  throughput objective (a max, not a sum), the exact minimax
  :class:`BottleneckLattice` — and, for :meth:`QueryEngine.frontier`,
  the exact non-dominated-label :class:`ParetoLattice`.

Both return identically-shaped ranked :class:`PartitionConfig` lists, so the
paper's experiments and the 1000-node fleet path share one API.

A query names one **operating point** — a batch size and a per-resource
replica budget — and every cost is priced at that point from the DB's
measured batch profiles.  Beyond the single-objective ``run``,
:meth:`QueryEngine.frontier` sweeps the candidate operating points
(measured batch sizes × replica budget) and returns the Pareto
non-dominated set over (latency, throughput, transfer) — the trade-off
surface deployments actually choose between, from latency-at-batch-1 to
throughput-at-max-batch with replicated stages.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field, replace

from .bench import BenchmarkDB
from .network import NetworkModel
from .partition import (BottleneckLattice, ChainPlan, Constraints, CostModel,
                        DagCostModel, LabelState, Objective,
                        ThroughputObjective, LATENCY,
                        ParetoLattice, PartitionConfig, PartitionLattice,
                        SPSolver, dag_config_satisfies, dag_search_space,
                        enumerate_dag_partitions, enumerate_partitions,
                        ordered_pipelines, pareto_frontier, rank,
                        trim_replicas)
from .resources import Resource

# auto-dispatch crossover between the paper-faithful exhaustive strategy
# and the vectorised lattices.  Re-measured after the label DPs went
# vectorised (PR 8): a cold lattice solve beats cold enumeration from a
# few hundred configs and a warm one (cached pool) from ~3k, so the old
# 200_000 — which encoded per-label Python DP cost — kept enumeration far
# past its win region.  10_000 keeps paper-testbed-sized spaces (~2.4k)
# on the exhaustive path, which doubles as the validation oracle, and
# dispatches everything larger to the lattices.
EXHAUSTIVE_LIMIT = 10_000
# enumerated-partition pools (and cost models) are cached per operating
# point; a frontier sweep touches one per measured batch size, so keep a
# small LRU rather than letting a long-lived engine accrete one ~200k-config
# pool per (batch, replica-budget) key ever queried
CACHE_POINTS = 8


def _cache_get(cache: dict, key):
    """Dict-as-LRU: hit moves the key to the back (most recent)."""
    if key not in cache:
        return None
    val = cache.pop(key)
    cache[key] = val
    return val


def _cache_put(cache: dict, key, val, limit: int = CACHE_POINTS):
    cache.pop(key, None)
    cache[key] = val
    while len(cache) > limit:
        cache.pop(next(iter(cache)))
    return val


def _op_key(cfg: PartitionConfig) -> tuple:
    return (cfg.segments, cfg.batch_size, cfg.replicas)


def _cons_key(cons: Constraints) -> tuple:
    """Hashable signature of a Constraints — the cache key for everything
    derived from the constraint structure (ChainPlan, warm SP solvers)."""
    return (cons.must_use, tuple(sorted(cons.exclude)),
            tuple(sorted(cons.pin.items())),
            tuple(sorted(cons.max_link_bytes.items())),
            tuple(sorted(cons.max_resource_time.items())),
            tuple(sorted(cons.min_blocks_on.items())))


def _dedupe(configs: list[PartitionConfig]) -> list[PartitionConfig]:
    seen: set = set()
    out = []
    for cfg in configs:
        k = _op_key(cfg)
        if k not in seen:
            seen.add(k)
            out.append(cfg)
    return out


@dataclass
class Query:
    """A user query (paper Step 6 examples map 1:1 onto these fields).

    ``batch_size`` and ``replicas`` (a per-resource replica *budget*:
    resource name -> max copies a stage placed there may use) select the
    operating point ``run`` prices; ``batch_sizes`` optionally restricts
    the operating points ``frontier`` sweeps (default: every batch size
    the DB measured).  ``frontier_epsilon`` is the lattice frontier's
    ε-dominance knob (0.0 == exact; > 0 bounds label-set growth on
    fleet-sized spaces at a bounded relative error).
    """

    objective: Objective = LATENCY
    top_n: int = 3
    # operating point
    batch_size: int = 1
    replicas: dict[str, int] = field(default_factory=dict)
    batch_sizes: tuple[int, ...] | None = None     # frontier sweep override
    frontier_epsilon: float = 0.0                  # ε-dominance (0 == exact)
    # constraints
    must_use: tuple[str, ...] = ()
    exclude: tuple[str, ...] = ()
    pin: dict[int, str] = field(default_factory=dict)
    max_link_bytes: dict[tuple[str, str], float] = field(default_factory=dict)
    max_resource_time: dict[str, float] = field(default_factory=dict)
    min_blocks_on: dict[str, int] = field(default_factory=dict)
    pipelines: tuple[tuple[str, ...], ...] | None = None   # restrict pipelines

    def __post_init__(self):
        # normalize the sequence-valued fields once, so every strategy
        # (enumeration cache, restricted enumeration, lattice) compares
        # against the same shapes — a pipe supplied as a list used to
        # enumerate its configs and then be filtered out one by one
        self.must_use = tuple(self.must_use)
        self.exclude = tuple(self.exclude)
        if self.pipelines is not None:
            self.pipelines = tuple(tuple(p) for p in self.pipelines)
        if self.frontier_epsilon < 0.0:
            raise ValueError(
                f"frontier_epsilon must be >= 0, got {self.frontier_epsilon}")

    def constraints(self) -> Constraints:
        return Constraints(must_use=self.must_use, exclude=self.exclude,
                           pin=self.pin, max_link_bytes=self.max_link_bytes,
                           max_resource_time=self.max_resource_time,
                           min_blocks_on=self.min_blocks_on)


@dataclass
class QueryResult:
    configs: list[PartitionConfig]
    query_time_s: float
    strategy: str
    # label-set statistics, populated by every lattice-strategy path
    # (ParetoLattice frontier, PartitionLattice/BottleneckLattice k-best,
    # SPSolver DAG solves): how many vector labels survived per-state
    # dominance pruning across all states, and how many were pruned
    labels_kept: int = 0
    labels_pruned: int = 0
    # pure solver wall time: the strategy call only, excluding constraint
    # normalisation, cost-model construction/lookup and diagnostics — the
    # number the smoke JSONs compare against the exhaustive oracle
    solve_seconds: float = 0.0
    # scission-lint findings for this query (repro_torch.analysis.plan_lint):
    # structural constraint problems, batch-clamp warnings drained from the
    # DB, and — for an empty result no structural error explains — the
    # exact SCN109 joint-unsatisfiability verdict.  An empty ``configs``
    # therefore always arrives with a machine-checkable explanation.
    diagnostics: list = field(default_factory=list)

    @property
    def best(self) -> PartitionConfig:
        return self.configs[0]


class QueryEngine:
    """Step 6 over one (model benchmark DB, resource set, network)."""

    def __init__(self, db: BenchmarkDB, resources: list[Resource],
                 network: NetworkModel, source: str, input_bytes: float,
                 block_preds: list | None = None, sp_tree=None):
        self.db = db
        self.resources = resources
        self.network = network
        self.source = source
        self.input_bytes = input_bytes
        # DAG mode: block-level edges (BlockDag.preds) + the SP
        # decomposition tree.  A chain-shaped (or absent) block_preds keeps
        # every solve on the untouched chain code paths, bit-identically.
        self.block_preds = [list(p) for p in block_preds] \
            if block_preds is not None else None
        self.sp_tree = sp_tree
        self.is_dag = (self.block_preds is not None and any(
            ps != ([] if i == 0 else [i - 1])
            for i, ps in enumerate(self.block_preds)))
        # cost models and enumeration caches are per operating point
        # (batch size, replica budget) — the batch-1 single-replica model
        # stays constructed eagerly as the legacy `.cost` view
        self._costs: dict[tuple, CostModel] = {}
        self.cost = self._cost_for()
        # cost-model soundness lint (repro_torch.analysis.cost_lint), run once at
        # construction: SCN4xx findings describe premises the exact DPs
        # assume about this DB / network / cost model, so they hold for (and
        # are attached to) every result this engine answers
        from ..analysis.cost_lint import lint_cost
        self._cost_diags = lint_cost(
            db, network=network, resources=[r.name for r in resources],
            cost=self.cost)
        self._exhaustive_cache: dict[tuple, list[PartitionConfig]] = {}
        self._restricted_cache: dict[tuple, list[PartitionConfig]] = {}
        # batch-independent solve structure (ChainPlan) per constraint
        # signature: one plan prices every operating point of a frontier
        # sweep and every elastic re-plan at the same membership
        self._plan_cache: dict[tuple, ChainPlan] = {}
        # warm SPSolver per (constraints, operating point, epsilon): the
        # solver memoises its per-block transition tables and final label
        # sets, so a repeated DAG query re-prices instead of re-solving
        self._sp_cache: dict[tuple, SPSolver] = {}

    # -- operating points ----------------------------------------------------
    @staticmethod
    def _point_key(batch_size: int = 1,
                   replicas: dict[str, int] | None = None) -> tuple:
        return (batch_size, tuple(sorted((replicas or {}).items())))

    def _cost_for(self, query: Query | None = None) -> CostModel:
        batch = query.batch_size if query is not None else 1
        reps = dict(query.replicas) if query is not None else {}
        key = self._point_key(batch, reps)
        cost = _cache_get(self._costs, key)
        if cost is None:
            if self.is_dag:
                cost = DagCostModel(
                    db=self.db, resources=self.resources,
                    network=self.network, source=self.source,
                    input_bytes=self.input_bytes, batch_size=batch,
                    replica_budget=reps, block_preds=self.block_preds,
                    tree=self.sp_tree)
            else:
                cost = CostModel(
                    db=self.db, resources=self.resources,
                    network=self.network, source=self.source,
                    input_bytes=self.input_bytes,
                    batch_size=batch, replica_budget=reps)
            cost = _cache_put(self._costs, key, cost)
        return cost

    def _plan_for(self, cons: Constraints) -> ChainPlan:
        """Batch-independent :class:`ChainPlan` for a constraint signature
        (small LRU).  The plan captures everything a lattice/SP solve needs
        that does not depend on the operating point — resource axis, tier
        transition matrix, link latency/bandwidth/limit matrices, per-block
        ``allowed`` masks — so a frontier sweep solves the structure once
        and re-prices per (batch, replicas), and elastic re-plans at an
        unchanged membership skip the rebuild entirely."""
        key = _cons_key(cons)
        plan = _cache_get(self._plan_cache, key)
        if plan is None:
            plan = _cache_put(self._plan_cache, key,
                              ChainPlan(self.cost, cons))
        return plan

    def _sp_for(self, cons: Constraints, cost: CostModel, query: Query,
                epsilon: float = 0.0) -> SPSolver:
        """Warm :class:`SPSolver` per (constraints, operating point, ε)
        (small LRU).  Reusing the solver keeps its per-block transition
        tables and memoised final label sets across queries, so repeated
        solves at one operating point — e.g. the same query under several
        objectives, or a solve followed by a frontier — skip the DP."""
        key = (_cons_key(cons),
               self._point_key(query.batch_size, query.replicas),
               float(epsilon))
        solver = _cache_get(self._sp_cache, key)
        if solver is None:
            solver = _cache_put(
                self._sp_cache, key,
                SPSolver(cost, cons, epsilon=epsilon,
                         plan=self._plan_for(cons)))
        return solver

    def _frontier_batches(self, query: Query) -> list[int]:
        """Batch sizes the frontier sweeps: an explicit ``Query.batch_sizes``
        wins; otherwise every batch the DB measured for this engine's
        resources (so a legacy batch-1 DB sweeps exactly the paper's single
        operating point).  Same contract as ``run``: an unmeasurable
        operating point is an error, not a silently-skipped candidate —
        the profile cannot price it without extrapolating."""
        names = [r.name for r in self.resources]
        if query.batch_sizes is None:
            return self.db.measured_batches(names)
        max_batch = self.db.max_batch(names)
        batches = sorted({int(b) for b in query.batch_sizes})
        bad = [b for b in batches if not 1 <= b <= max_batch]
        if bad:
            raise ValueError(
                f"requested batch_sizes {bad} are outside the measured "
                f"range (1..{max_batch}) for model {self.db.model!r}; "
                "re-run benchmark_model(batch_sizes=...) to cover them")
        return batches

    # -- sizing -------------------------------------------------------------
    def _valid_pipelines(self, pipes) -> tuple[tuple[str, ...], ...]:
        """Normalize a ``Query.pipelines`` restriction: keep only pipes made
        of known resources in strictly ascending tier order — the only
        sequences any strategy can produce (data flows device -> edge ->
        cloud).  Applying this in one place keeps the exhaustive-cache,
        restricted-enumeration and lattice branches consistent."""
        order = {r.name: r.order for r in self.resources}
        return tuple(
            tuple(p) for p in pipes
            if all(n in order for n in p)
            and all(order[a] < order[b] for a, b in zip(p, p[1:])))

    def _admissible_pipes(self, query: Query | None = None
                          ) -> tuple[tuple[str, ...], ...]:
        """The pipelines the query can actually draw configs from: the
        valid ordered pipelines (or the query's ``pipelines`` restriction)
        that contain every *demanded* resource — ``must_use``, a
        ``min_blocks_on`` floor >= 1 (presence implied) or a ``pin``
        target — and avoid every excluded one.  Configs from any other
        pipe are rejected by the constraint filter anyway, so restricting
        enumeration (and the counted search space) to these pipes changes
        no result — it only makes the exhaustive strategy's cost, and the
        exhaustive/lattice crossover decision, reflect the constrained
        query actually being answered."""
        pipes = ordered_pipelines(self.resources) \
            if query is None or query.pipelines is None \
            else self._valid_pipelines(query.pipelines)
        if query is None:
            return tuple(pipes)
        need = set(query.must_use) | set(query.pin.values()) | {
            r for r, n in query.min_blocks_on.items() if n >= 1}
        excl = set(query.exclude)
        return tuple(p for p in pipes
                     if need <= set(p) and not (set(p) & excl))

    def _search_space(self, query: Query | None = None) -> int:
        """Number of configurations the query actually ranges over — honors
        a ``Query.pipelines`` restriction and the pipe-level implications
        of the query's constraints (see :meth:`_admissible_pipes`)."""
        if self.is_dag:
            cons = query.constraints() if query is not None else Constraints()
            pipes = None if query is None or query.pipelines is None \
                else self._admissible_pipes(query)
            return self._dag_space(cons, pipes)
        B = self.db.n_blocks
        total = 0
        for pipe in self._admissible_pipes(query):
            k = len(pipe)
            if k <= B:
                total += math.comb(B - 1, k - 1)
        return total

    def _dag_space(self, cons: Constraints,
                   pipes: tuple[tuple[str, ...], ...] | None) -> int:
        """Counted tier-monotone assignment space of a DAG engine, with an
        early cutoff just past the crossover limit."""
        cost = self.cost
        if pipes is None:
            return dag_search_space(cost, cons, limit=EXHAUSTIVE_LIMIT)
        all_names = {r.name for r in self.resources}
        total = 0
        for pipe in pipes:
            pcons = Constraints(
                must_use=pipe,
                exclude=tuple(set(cons.exclude) | (all_names - set(pipe))),
                pin=cons.pin)
            total += dag_search_space(cost, pcons, limit=EXHAUSTIVE_LIMIT)
            if total > EXHAUSTIVE_LIMIT:
                break
        return total

    # -- execution ----------------------------------------------------------
    def run(self, query: Query | None = None) -> QueryResult:
        query = query or Query()
        t0 = time.perf_counter()
        cons = query.constraints()
        cost = self._cost_for(query)
        kept = pruned = 0
        exhaustive = self._search_space(query) <= EXHAUSTIVE_LIMIT
        t1 = time.perf_counter()
        if exhaustive:
            configs = self._run_exhaustive(query, cons, cost)
            strategy = "exhaustive"
        elif self.is_dag:
            configs, kept, pruned = self._run_sp(query, cons, cost)
            strategy = "lattice"
        else:
            configs, kept, pruned = self._run_lattice(query, cons, cost)
            strategy = "lattice"
        solve_s = time.perf_counter() - t1
        result = QueryResult(configs=configs,
                             query_time_s=time.perf_counter() - t0,
                             strategy=strategy,
                             labels_kept=kept, labels_pruned=pruned,
                             solve_seconds=solve_s)
        self._attach_diagnostics(result, query, cons, [cost],
                                 batches=[query.batch_size])
        return result

    def frontier(self, query: Query | None = None,
                 strategy: str | None = None) -> QueryResult:
        """Pareto non-dominated set over (latency, throughput, transfer),
        swept across operating points (measured batch sizes × the query's
        replica budget).

        Both strategies are exact (chosen by search-space size, or forced
        via ``strategy``):

        * ``"exhaustive"`` — non-dominated filter over the full
          (constraint-filtered) enumeration: the paper-faithful path on
          small spaces and the validation oracle the lattice is checked
          against (tests + ``bench_partitions --smoke-frontier``).
        * ``"lattice"`` — :class:`ParetoLattice` per operating point: every
          (block, resource, must-use-mask) state keeps its exact
          non-dominated label set, replacing the three-objective k-best
          union that could silently miss non-dominated operating points.
          ``Query.frontier_epsilon`` > 0 trades a bounded relative error
          for smaller label sets on fleet-sized spaces; label-set
          statistics land on ``QueryResult.labels_kept`` /
          ``labels_pruned``.  Every constraint — including the
          path-dependent ``max_resource_time`` / ``min_blocks_on`` — is
          folded into the DP state, so both strategies return the same
          result set on every constrained query (no post-filtering that
          could under-fill the lattice result).

        Points from every swept operating point compete in one final
        Pareto filter, so the result is the exact global frontier over the
        swept points.  Replica counts of returned points are trimmed to
        the minimum achieving their bottleneck.  Results are sorted by
        latency.
        """
        query = query or Query()
        if strategy not in (None, "exhaustive", "lattice"):
            raise ValueError(f"unknown frontier strategy {strategy!r}")
        t0 = time.perf_counter()
        cons = query.constraints()
        if strategy is None:
            strategy = "exhaustive" \
                if self._search_space(query) <= EXHAUSTIVE_LIMIT else "lattice"
        kept = pruned = 0
        cands: list[PartitionConfig] = []
        batches = self._frontier_batches(query)
        costs: list[CostModel] = []
        t1 = time.perf_counter()
        for batch in batches:
            q = replace(query, batch_size=batch)
            cost = self._cost_for(q)
            costs.append(cost)
            if strategy == "exhaustive":
                cands.extend(self._filtered_exhaustive(q, cons, cost))
            else:
                configs, k, p = self._lattice_frontier(q, cons, cost)
                cands.extend(configs)
                kept += k
                pruned += p
        front = [trim_replicas(c) for c in pareto_frontier(_dedupe(cands))]
        front.sort(key=lambda c: (c.latency_s, c.bottleneck_s,
                                  c.transfer_bytes))
        solve_s = time.perf_counter() - t1
        result = QueryResult(configs=front,
                             query_time_s=time.perf_counter() - t0,
                             strategy=strategy,
                             labels_kept=kept, labels_pruned=pruned,
                             solve_seconds=solve_s)
        # the frontier ignores top_n, and a timing-dependent error must
        # hold at every swept batch before it explains an empty frontier
        self._attach_diagnostics(result, query, cons, costs,
                                 batches=batches, check_top_n=False)
        return result

    def frontier_incremental(self, query: Query | None = None,
                             prev_states: dict[int, LabelState] | None = None
                             ) -> tuple[QueryResult, dict[int, LabelState]]:
        """Label-reusing frontier sweep for elastic re-plans.

        Same result contract as :meth:`frontier` under the lattice
        strategy, but every swept operating point keeps its final label
        arrays (:class:`LabelState`, keyed by batch size) and a later call
        at a changed resource membership warm-starts from them: a departed
        resource invalidates only labels whose paths touch it
        (:meth:`ParetoLattice.resume` replays the untouched prefix), a
        joined resource generates only the delta paths that visit it
        (:meth:`ParetoLattice.extend`).  Both fall back to a cold solve
        whenever reuse would be unsound (ε mismatch, changed must-set,
        non-prefix join order, fleets past the bitmask width), so the
        returned frontier is always exactly the cold answer.

        Caller contract: pass ``prev_states`` only across *membership*
        changes — per-(block, resource) costs and the network must be
        unchanged, as labels price both.  On a network/bandwidth change
        pass ``None`` to force cold solves.  DAG and pipeline-restricted
        engines fall back to a plain :meth:`frontier` and return no
        states.
        """
        query = query or Query()
        if self.is_dag or query.pipelines is not None:
            return self.frontier(query), {}
        t0 = time.perf_counter()
        cons = query.constraints()
        prev_states = prev_states or {}
        plan = self._plan_for(cons)
        kept = pruned = 0
        cands: list[PartitionConfig] = []
        states: dict[int, LabelState] = {}
        batches = self._frontier_batches(query)
        costs: list[CostModel] = []
        t1 = time.perf_counter()
        for batch in batches:
            q = replace(query, batch_size=batch)
            cost = self._cost_for(q)
            costs.append(cost)
            lat = ParetoLattice(cost, cons,
                                epsilon=query.frontier_epsilon, plan=plan)
            prev = prev_states.get(batch)
            if prev is None:
                configs = lat.solve(keep_state=True)
            elif all(n in prev.names for n in lat.names):
                configs = lat.resume(prev, keep_state=True)
            else:
                configs = lat.extend(prev, keep_state=True)
            if lat.state is not None:
                states[batch] = lat.state
            cands.extend(configs)
            kept += lat.labels_kept
            pruned += lat.labels_pruned
        front = [trim_replicas(c) for c in pareto_frontier(_dedupe(cands))]
        front.sort(key=lambda c: (c.latency_s, c.bottleneck_s,
                                  c.transfer_bytes))
        solve_s = time.perf_counter() - t1
        result = QueryResult(configs=front,
                             query_time_s=time.perf_counter() - t0,
                             strategy="lattice",
                             labels_kept=kept, labels_pruned=pruned,
                             solve_seconds=solve_s)
        self._attach_diagnostics(result, query, cons, costs,
                                 batches=batches, check_top_n=False)
        return result, states

    def _attach_diagnostics(self, result: QueryResult, query: Query,
                            cons: Constraints, costs: list[CostModel],
                            batches: list[int],
                            check_top_n: bool = True) -> None:
        """Run the plan linter (repro_torch.analysis) over the just-answered query
        and attach its findings — plus any batch-clamp warnings the pricing
        drained out of the DB.  When the result is empty and no structural
        error explains it, the exact joint-satisfiability sweep (SCN109)
        supplies the explanation.  Runs *after* the solve so the paper's
        <50 ms ``query_time_s`` metric stays a pure solve time.
        """
        from ..analysis.diagnostics import dedupe
        from ..analysis.plan_lint import explain_empty, lint_plan

        diags = list(self._cost_diags)
        diags += lint_plan(query, self.resources, self.network, self.db,
                           source=self.source, batches=batches,
                           check_top_n=check_top_n)
        if hasattr(self.db, "drain_diagnostics"):
            diags.extend(self.db.drain_diagnostics())
        if not result.configs:
            diags.extend(explain_empty(query, cons, costs, prior=diags))
        result.diagnostics = dedupe(diags)

    def _lattice_frontier(self, query: Query, cons: Constraints,
                          cost: CostModel
                          ) -> tuple[list[PartitionConfig], int, int]:
        """One operating point's exact frontier via :class:`ParetoLattice`,
        honoring a ``Query.pipelines`` restriction the same way
        :meth:`_run_lattice` does (per-pipe solves; overlapping pipe
        spaces are fine — the caller Pareto-filters the deduped union).
        Returns (configs, labels_kept, labels_pruned)."""
        eps = query.frontier_epsilon
        if self.is_dag:
            if query.pipelines is None:
                solver = self._sp_for(cons, cost, query, epsilon=eps)
                return (solver.frontier(), solver.labels_kept,
                        solver.labels_pruned)
            merged: list[PartitionConfig] = []
            kept = pruned = 0
            for pcons in self._pipe_constraints(query):
                solver = self._sp_for(pcons, cost, query, epsilon=eps)
                merged.extend(solver.frontier())
                kept += solver.labels_kept
                pruned += solver.labels_pruned
            return merged, kept, pruned
        if query.pipelines is None:
            lattice = ParetoLattice(cost, cons, epsilon=eps,
                                    plan=self._plan_for(cons))
            return lattice.solve(), lattice.labels_kept, lattice.labels_pruned
        merged = []
        kept = pruned = 0
        for pcons in self._pipe_constraints(query):
            lattice = ParetoLattice(cost, pcons, epsilon=eps,
                                    plan=self._plan_for(pcons))
            merged.extend(lattice.solve())
            kept += lattice.labels_kept
            pruned += lattice.labels_pruned
        return merged, kept, pruned

    def _lattice_for(self, cons: Constraints, objective: Objective,
                     cost: CostModel):
        plan = self._plan_for(cons)
        if isinstance(objective, ThroughputObjective):
            return BottleneckLattice(cost, cons, plan=plan)
        return PartitionLattice(cost, cons, objective, plan=plan)

    def _pipe_constraints(self, query: Query):
        """Per-pipe lattice restrictions for a ``Query.pipelines`` query:
        solving with must_use == the pipe and everything else excluded
        admits exactly that resource sequence (transitions only move to
        later tiers, so the order is forced).  Yields one Constraints per
        admissible pipe — shared by the k-best and frontier lattice paths
        so both honor identical restrictions."""
        all_names = {r.name for r in self.resources}
        # a pipe missing a demanded resource (must_use, or a min_blocks_on
        # floor >= 1, which implies presence) can never yield a feasible
        # config — skip the solve instead of letting the lattice discover
        # the infeasibility
        need = set(query.must_use) | {
            r for r, n in query.min_blocks_on.items() if n >= 1}
        for pipe in self._valid_pipelines(query.pipelines):
            members = set(pipe)
            if any(m not in members for m in need):
                continue
            if members & set(query.exclude):
                continue
            yield Constraints(
                must_use=pipe,
                exclude=tuple(set(query.exclude) | (all_names - members)),
                pin=query.pin, max_link_bytes=query.max_link_bytes,
                max_resource_time=query.max_resource_time,
                min_blocks_on=query.min_blocks_on)

    def _run_lattice(self, query: Query, cons: Constraints, cost: CostModel
                     ) -> tuple[list[PartitionConfig], int, int]:
        """Returns (configs, labels_kept, labels_pruned)."""
        if query.pipelines is None:
            lat = self._lattice_for(cons, query.objective, cost)
            return (lat.solve(top_n=query.top_n),
                    lat.labels_kept, lat.labels_pruned)
        merged: list[PartitionConfig] = []
        kept = pruned = 0
        for pcons in self._pipe_constraints(query):
            lat = self._lattice_for(pcons, query.objective, cost)
            merged.extend(lat.solve(top_n=query.top_n))
            kept += lat.labels_kept
            pruned += lat.labels_pruned
        return (rank(_dedupe(merged), query.objective, query.top_n),
                kept, pruned)

    def _run_sp(self, query: Query, cons: Constraints, cost: CostModel
                ) -> tuple[list[PartitionConfig], int, int]:
        """Large-space DAG solve via :class:`SPSolver` (the DAG analogue of
        ``_run_lattice``, objective handling included — the solver's label
        vectors carry both the additive and the bottleneck components).
        Returns (configs, labels_kept, labels_pruned)."""
        if query.pipelines is None:
            solver = self._sp_for(cons, cost, query)
            return (solver.solve(query.objective, top_n=query.top_n),
                    solver.labels_kept, solver.labels_pruned)
        merged: list[PartitionConfig] = []
        kept = pruned = 0
        for pcons in self._pipe_constraints(query):
            solver = self._sp_for(pcons, cost, query)
            merged.extend(solver.solve(query.objective, top_n=query.top_n))
            kept += solver.labels_kept
            pruned += solver.labels_pruned
        return (rank(_dedupe(merged), query.objective, query.top_n),
                kept, pruned)

    def _run_exhaustive(self, query: Query, cons: Constraints,
                        cost: CostModel) -> list[PartitionConfig]:
        return rank(self._filtered_exhaustive(query, cons, cost),
                    query.objective, query.top_n)

    def _filtered_exhaustive(self, query: Query, cons: Constraints,
                             cost: CostModel) -> list[PartitionConfig]:
        if self.is_dag:
            return self._dag_filtered(query, cons, cost)
        point = self._point_key(query.batch_size, query.replicas)
        admissible = self._admissible_pipes(query)
        if self._search_space() > EXHAUSTIVE_LIMIT:
            # only the constrained space is small — enumerate just the
            # admissible pipelines instead of building the full cache
            # (cached per pipeline set so repeated queries stay inside the
            # 50 ms budget)
            ck = (point, admissible)
            pool = _cache_get(self._restricted_cache, ck)
            if pool is None:
                pool = _cache_put(self._restricted_cache, ck,
                                  enumerate_partitions(cost,
                                                       pipelines=admissible))
        else:
            pool = _cache_get(self._exhaustive_cache, point)
            if pool is None:
                pool = _cache_put(self._exhaustive_cache, point,
                                  enumerate_partitions(cost))
        # filter against the *normalized* pipeline set: the enumeration
        # paths normalize through _valid_pipelines, so comparing raw query
        # values (e.g. pipes supplied as lists) would reject every config
        allowed_pipes = None if query.pipelines is None else \
            set(self._valid_pipelines(query.pipelines))
        out = []
        for cfg in pool:
            if allowed_pipes is not None and \
                    cfg.resources not in allowed_pipes:
                continue
            if not self._config_satisfies(cfg, cons, cost):
                continue
            out.append(cfg)
        return out

    def _dag_filtered(self, query: Query, cons: Constraints,
                      cost: CostModel) -> list[PartitionConfig]:
        """Exhaustive DAG pool + constraint filter.  Enumeration applies
        ``exclude``/``pin`` up front (they shrink the recursion), so the
        pool cache is keyed by them alongside the operating point."""
        point = self._point_key(query.batch_size, query.replicas)
        ck = (point, tuple(sorted(query.exclude)),
              tuple(sorted(query.pin.items())))
        pool = _cache_get(self._exhaustive_cache, ck)
        if pool is None:
            pool = _cache_put(self._exhaustive_cache, ck,
                              enumerate_dag_partitions(cost, cons))
        allowed_pipes = None if query.pipelines is None else \
            set(self._valid_pipelines(query.pipelines))
        out = []
        for cfg in pool:
            if allowed_pipes is not None and \
                    tuple(cfg.pipeline) not in allowed_pipes:
                continue
            if not dag_config_satisfies(cost, cfg, cons):
                continue
            out.append(cfg)
        return out

    def _config_satisfies(self, cfg: PartitionConfig, cons: Constraints,
                          cost: CostModel) -> bool:
        used = set(cfg.resources)
        if any(m not in used for m in cons.must_use):
            return False
        if used & cons.exclude:
            return False
        for blk, res in cons.pin.items():
            ok = any(s.resource == res and s.start <= blk <= s.end
                     for s in cfg.segments)
            if not ok:
                return False
        for i, seg in enumerate(cfg.segments[:-1]):
            nxt = cfg.segments[i + 1]
            nbytes = float(cost.out_bytes[seg.end])
            if not cons.transition_allowed(seg.resource, nxt.resource, nbytes):
                return False
        if cfg.segments[0].resource != cost.source:
            if not cons.transition_allowed(cost.source,
                                           cfg.segments[0].resource,
                                           cost.batch_input_bytes):
                return False
        return cons.path_feasible(cfg)
