"""Partition configuration generation and ranking (Scission §II-C Steps 4-5).

Two engines over the same cost model:

* :func:`enumerate_partitions` — the paper's **exhaustive** enumeration of
  every native and distributed configuration over every ordered resource
  pipeline.  Kept as the validation oracle and for rich post-hoc queries.
* :class:`PartitionLattice` — a **beyond-paper** Viterbi lattice over
  (block, resource) states.  Exact under the paper's additive cost model
  (assumptions 1 and 2 in §III-A), O(B·R²·2^R) with must-use masks, and
  supports k-best (top-N) extraction.  This is what lets the same decision
  procedure scale from the paper's 3-tier testbed to a 1000+-node fleet,
  and what keeps re-planning (elastic runtime) inside the paper's 50 ms
  query budget.
* :class:`BottleneckLattice` — the exact min-bottleneck (max-throughput)
  companion DP.  Under steady-state pipelined serving the objective is the
  *max* over stage/hop times, not their sum, so the additive Viterbi
  lattice is not exact; this DP works at segment granularity with minimax
  composition instead.
* :class:`ParetoLattice` — the exact multi-objective companion: a
  label-correcting DP over the same (block, resource, must-use-mask)
  states where each state keeps its full **non-dominated set** of vector
  labels over (latency, bottleneck, transfer) instead of a scalar k-best
  list.  Latency/transfer compose additively and the bottleneck by
  minimax — all monotone — so per-state dominance pruning is exact and
  ``QueryEngine.frontier`` no longer has to approximate the trade-off
  surface from three single-objective k-best solves on fleet-sized
  spaces.  An optional ε-dominance knob bounds label-set growth.

Every Step-6 constraint kind — including the path-dependent
``max_resource_time`` / ``min_blocks_on`` — is folded into each lattice's
DP state (see :class:`Constraints` / :class:`_LatticeBase`), so all three
solvers return the true constrained optimum / frontier with no
post-filtering.

Cost model (paper's two assumptions, validated in tests/test_bench.py):

    latency(config) = comm(source -> r_1, input_bytes)
                    + Σ_segments Σ_blocks time(r_i, b)
                    + Σ_cuts     comm(r_i -> r_{i+1}, out_bytes[cut])

Pipelined-serving model (streamed deployments): requests move through the
pipeline in batches of ``batch_size`` and each compute stage may run on
``replicas[k]`` copies of its resource, so the steady-state rate is limited
by the slowest *effective* stage — a compute segment serves
``replicas[k] * batch`` requests per ``stage_time(batch)``, a communication
hop (including the source->first-resource input hop) serves ``batch``
requests per per-batch transfer time:

    period_k    = stage_time_k(batch) / (replicas_k * batch)   (compute)
    period_j    = hop_time_j(batch)   / batch                  (comm)
    bottleneck  = max_k period_k
    throughput_rps = 1 / bottleneck

With ``batch_size == 1`` and all-ones replicas this reduces to the
one-request-per-stage model (max over raw stage/hop times).  Stage times at
``batch > 1`` come from the benchmark DB's measured batch profiles
(log-linear interpolation between measured points, clamped at the measured
extremes), so batching economies are priced empirically, not assumed.
"""

from __future__ import annotations

import itertools
import math
from dataclasses import dataclass, field, replace
from typing import Callable, Iterable, Sequence

import numpy as np

from ..bench import BenchmarkDB
from ..network import NetworkModel
from ..resources import Resource
from .labelset import grouped_nondominated, grouped_topk, nondominated_rows


@dataclass(frozen=True)
class Segment:
    resource: str
    start: int          # first block index (inclusive)
    end: int            # last block index (inclusive)


@dataclass
class PartitionConfig:
    """One ranked configuration (a row of the paper's Table IV).

    A config is an **operating point**: segments plus the batch size the
    per-stage timings were priced at and the per-segment replica counts.
    ``latency_s`` / ``stage_compute_s`` / ``stage_comm_s`` /
    ``transfer_bytes`` are all *per batch* on *one replica* (at
    ``batch_size == 1`` that is exactly the paper's per-request model);
    ``bottleneck_s`` / ``throughput_rps`` are per-request effective values.
    """

    model: str
    segments: tuple[Segment, ...]
    latency_s: float
    compute_s: dict[str, float]
    comm_s: float
    transfer_bytes: float           # total inter-resource bytes (incl. input)
    input_comm_s: float = 0.0
    # per-stage timings for pipelined serving: one compute time per segment,
    # one comm time per hop between consecutive segments
    stage_compute_s: tuple[float, ...] = ()
    stage_comm_s: tuple[float, ...] = ()
    # operating point: batch the stage timings were priced at, and replica
    # count per segment (empty tuple == one replica everywhere)
    batch_size: int = 1
    replicas: tuple[int, ...] = ()

    @property
    def resources(self) -> tuple[str, ...]:
        return tuple(s.resource for s in self.segments)

    @property
    def is_native(self) -> bool:
        return len(self.segments) == 1

    def replica_count(self, k: int) -> int:
        """Replicas serving compute stage ``k`` (1 when unspecified)."""
        return self.replicas[k] if k < len(self.replicas) else 1

    @property
    def stage_periods_s(self) -> tuple[float, ...]:
        """Effective per-request service period of every pipeline stage, in
        pipeline order: input hop (if any), then each compute segment
        followed by its outgoing comm hop.  A compute stage with ``r``
        replicas at batch ``b`` serves ``r*b`` requests per ``stage_time``;
        a hop serves ``b`` requests per per-batch transfer."""
        b = max(1, self.batch_size)
        periods: list[float] = []
        if self.input_comm_s > 0.0:
            periods.append(self.input_comm_s / b)
        for k, t in enumerate(self.stage_compute_s):
            periods.append(t / (self.replica_count(k) * b))
            if k < len(self.stage_comm_s):
                periods.append(self.stage_comm_s[k] / b)
        return tuple(periods)

    @property
    def bottleneck_s(self) -> float:
        """Slowest effective pipeline stage (replica- and batch-adjusted) —
        the steady-state per-request period under pipelined serving."""
        periods = self.stage_periods_s
        return max(periods) if periods else self.latency_s

    @property
    def throughput_rps(self) -> float:
        """Steady-state pipelined request rate = 1 / effective bottleneck."""
        b = self.bottleneck_s
        return 1.0 / b if b > 0.0 else float("inf")

    def describe(self) -> str:
        parts = [f"{s.resource}: {s.start}-{s.end}" if s.start != s.end
                 else f"{s.resource}: {s.start}" for s in self.segments]
        op = ""
        if self.batch_size != 1:
            op += f" batch={self.batch_size}"
        if any(r != 1 for r in self.replicas):
            op += " reps=" + "x".join(str(self.replica_count(k))
                                      for k in range(len(self.segments)))
        return (f"[{self.model}] " + " | ".join(parts)
                + f"  latency={self.latency_s * 1e3:.1f}ms"
                + f" thpt={self.throughput_rps:.1f}rps"
                + f" transfer={self.transfer_bytes / 1e6:.3f}MB" + op)


@dataclass
class CostModel:
    """Precomputed vectorised costs for one (model, resource set, network)
    at one operating point (batch size + per-resource replica budget).

    ``batch_size`` selects the per-batch block times from the DB's measured
    batch profiles (interpolated when unmeasured); ``replica_budget`` maps a
    resource name to the number of copies a stage placed on it may use
    (default 1).  All per-config quantities (latency, stage times, transfer)
    are per batch; the effective per-request stage periods divide by
    ``replicas * batch`` (compute) / ``batch`` (comm).
    """

    db: BenchmarkDB
    resources: list[Resource]
    network: NetworkModel
    source: str                      # where the input data originates
    input_bytes: float               # per request
    batch_size: int = 1
    replica_budget: dict[str, int] = field(default_factory=dict)

    times: np.ndarray = field(init=False)        # (R, B) per-batch seconds
    cum: np.ndarray = field(init=False)          # (R, B+1) prefix sums
    out_bytes: np.ndarray = field(init=False)    # (B,) per-batch bytes

    def __post_init__(self):
        names = [r.name for r in self.resources]
        missing = [n for n in names if n not in self.db.records]
        if missing:
            raise ValueError(
                f"resource(s) {', '.join(sorted(missing))} not benchmarked "
                f"for model {self.db.model!r}; run Scission.benchmark() / "
                "benchmark_resource() for them first")
        if self.batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {self.batch_size}")
        max_batch = self.db.max_batch(names)
        if self.batch_size > max_batch:
            # pricing batch b from a profile clamped at max_batch would
            # divide the clamped time by b — linear throughput extrapolation
            # the measurements do not support
            raise ValueError(
                f"batch_size {self.batch_size} exceeds the largest measured "
                f"batch ({max_batch}) for model {self.db.model!r}; "
                "re-run benchmark_model(batch_sizes=...) to cover it")
        bad = {r: n for r, n in self.replica_budget.items() if n < 1}
        if bad:
            raise ValueError(f"replica budget must be >= 1, got {bad}")
        self.times = self.db.times_matrix(names, batch=self.batch_size)
        self.cum = np.concatenate(
            [np.zeros((len(names), 1)), np.cumsum(self.times, axis=1)], axis=1)
        self.out_bytes = self.db.out_bytes_vector(batch=self.batch_size)
        self._idx = {n: i for i, n in enumerate(names)}

    @property
    def n_blocks(self) -> int:
        return self.db.n_blocks

    @property
    def batch_input_bytes(self) -> float:
        """Bytes of input data entering the pipeline per batch."""
        return self.input_bytes * self.batch_size

    def replicas_for(self, resource: str) -> int:
        return max(1, int(self.replica_budget.get(resource, 1)))

    def segment_time(self, resource: str, start: int, end: int) -> float:
        """Per-batch compute time of blocks ``start..end`` on one replica."""
        i = self._idx[resource]
        return float(self.cum[i, end + 1] - self.cum[i, start])

    def comm(self, src: str, dst: str, nbytes: float) -> float:
        return self.network.comm_time(src, dst, nbytes)

    # -- effective per-request periods (the minimax DP's stage costs) --------
    def stage_period(self, resource: str, start: int, end: int) -> float:
        """Per-request service period of a compute stage: ``replicas``
        copies each finish a batch of ``batch_size`` per segment time."""
        return self.segment_time(resource, start, end) / (
            self.replicas_for(resource) * self.batch_size)

    def hop_period(self, src: str, dst: str, nbytes: float) -> float:
        """Per-request service period of a comm hop moving ``nbytes`` (a
        per-batch quantity) between stages."""
        return self.comm(src, dst, nbytes) / self.batch_size

    def evaluate(self, segments: Sequence[Segment],
                 objective: "Objective | None" = None) -> PartitionConfig:
        compute = {}
        comm = 0.0
        xfer = 0.0
        first = segments[0].resource
        input_comm = 0.0
        if first != self.source:
            input_comm = self.comm(self.source, first, self.batch_input_bytes)
            xfer += self.batch_input_bytes
        stage_compute: list[float] = []
        stage_comm: list[float] = []
        for k, seg in enumerate(segments):
            t = self.segment_time(seg.resource, seg.start, seg.end)
            compute[seg.resource] = compute.get(seg.resource, 0.0) + t
            stage_compute.append(t)
            if k + 1 < len(segments):
                nbytes = float(self.out_bytes[seg.end])
                hop = self.comm(seg.resource, segments[k + 1].resource, nbytes)
                stage_comm.append(hop)
                comm += hop
                xfer += nbytes
        latency = input_comm + sum(compute.values()) + comm
        return PartitionConfig(
            model=self.db.model, segments=tuple(segments), latency_s=latency,
            compute_s=compute, comm_s=comm, transfer_bytes=xfer,
            input_comm_s=input_comm,
            stage_compute_s=tuple(stage_compute),
            stage_comm_s=tuple(stage_comm),
            batch_size=self.batch_size,
            replicas=tuple(self.replicas_for(s.resource) for s in segments))


@dataclass(frozen=True)
class Objective:
    """Ranking objective: minimise w_latency·latency + w_transfer·transfer.

    The paper's Step 5 default is pure latency; Step 6 allows data-transfer
    and combined objectives.
    """

    w_latency: float = 1.0
    w_transfer_per_mb: float = 0.0

    def score(self, cfg: PartitionConfig) -> float:
        return (self.w_latency * cfg.latency_s
                + self.w_transfer_per_mb * cfg.transfer_bytes / 1e6)


@dataclass(frozen=True)
class ThroughputObjective(Objective):
    """Maximise steady-state pipelined throughput == minimise the bottleneck
    stage time (max of stage compute and per-hop comm).

    Because the score is a *max* rather than a sum, the additive
    :class:`PartitionLattice` is not exact for this objective — the query
    engine dispatches it to :class:`BottleneckLattice` instead.
    """

    def score(self, cfg: PartitionConfig) -> float:
        return cfg.bottleneck_s


LATENCY = Objective()
TRANSFER = Objective(w_latency=0.0, w_transfer_per_mb=1.0)
THROUGHPUT = ThroughputObjective()


# ---------------------------------------------------------------------------
# Exhaustive enumeration (paper-faithful Step 4)
# ---------------------------------------------------------------------------

def ordered_pipelines(resources: list[Resource]) -> list[tuple[str, ...]]:
    """All ordered sub-pipelines: at most one resource per tier, data flows
    device -> edge -> cloud (the paper's native + distributed configs)."""
    tiers: dict[int, list[str]] = {}
    for r in sorted(resources, key=lambda r: r.order):
        tiers.setdefault(r.order, []).append(r.name)
    levels = [tiers[k] for k in sorted(tiers)]
    pipes: list[tuple[str, ...]] = []
    for mask in itertools.product(*[[None, *lvl] for lvl in levels]):
        pipe = tuple(m for m in mask if m is not None)
        if pipe:
            pipes.append(pipe)
    return pipes


def enumerate_partitions(cost: CostModel,
                         pipelines: Iterable[tuple[str, ...]] | None = None,
                         max_configs: int = 2_000_000
                         ) -> list[PartitionConfig]:
    """Every cut combination for every pipeline.  Exact but exponential in
    pipeline length; the lattice below is the scalable path."""
    B = cost.n_blocks
    pipelines = list(pipelines) if pipelines is not None else \
        ordered_pipelines(cost.resources)
    configs: list[PartitionConfig] = []
    n = 0
    for pipe in pipelines:
        k = len(pipe)
        if k > B:
            continue
        for cuts in itertools.combinations(range(1, B), k - 1):
            bounds = [0, *cuts, B]
            segs = [Segment(pipe[i], bounds[i], bounds[i + 1] - 1)
                    for i in range(k)]
            configs.append(cost.evaluate(segs))
            n += 1
            if n > max_configs:
                raise RuntimeError(
                    f"exhaustive enumeration exceeded {max_configs} configs; "
                    "use PartitionLattice")
    return configs


def rank(configs: list[PartitionConfig], objective: Objective = LATENCY,
         top_n: int | None = None) -> list[PartitionConfig]:
    out = sorted(configs, key=objective.score)
    return out if top_n is None else out[:top_n]


def trim_replicas(cfg: PartitionConfig) -> PartitionConfig:
    """Right-size an operating point: shrink each stage's replica count to
    the minimum that keeps the bottleneck (hence throughput) unchanged.

    A replica budget is an upper bound; a stage that is not the bottleneck
    may hit the same rate with fewer copies.  Frontier results are trimmed
    so operators never over-provision to match a reported operating point.
    """
    if not cfg.replicas or all(r == 1 for r in cfg.replicas):
        return cfg
    b = max(1, cfg.batch_size)
    bneck = cfg.bottleneck_s
    if bneck <= 0.0:
        return cfg
    trimmed = []
    for k, t in enumerate(cfg.stage_compute_s):
        need = max(1, math.ceil(t / (b * bneck) - 1e-12))
        trimmed.append(min(cfg.replica_count(k), need))
    return replace(cfg, replicas=tuple(trimmed))


# ---------------------------------------------------------------------------
# Pareto frontier over (latency, throughput, transfer)
# ---------------------------------------------------------------------------

def objective_vector(cfg: PartitionConfig) -> tuple[float, float, float]:
    """The canonical minimised objective vector of the frontier machinery:
    (latency_s, bottleneck_s, transfer_bytes) — ``bottleneck_s`` stands in
    for -throughput.  Every frontier comparison (Pareto filters, elastic
    ``frontier_shift``, bench equality gates) goes through this one
    definition."""
    return (cfg.latency_s, cfg.bottleneck_s, cfg.transfer_bytes)


_objective_vector = objective_vector        # internal alias


def dominates(a: PartitionConfig, b: PartitionConfig) -> bool:
    """True iff ``a`` is no worse than ``b`` on latency, throughput and
    transfer, and strictly better on at least one."""
    va, vb = _objective_vector(a), _objective_vector(b)
    return all(x <= y for x, y in zip(va, vb)) and va != vb


def pareto_frontier(configs: Sequence[PartitionConfig]
                    ) -> list[PartitionConfig]:
    """Exact non-dominated set over (latency, throughput, transfer).

    Processes candidates in lexicographic objective order so each point only
    needs checking against already-accepted frontier members (any dominator
    of p is itself dominated only by points that dominate p, and sorts
    before p).  Configs with identical objective vectors are all kept —
    they are distinct operating points with equal cost.
    """
    if not configs:
        return []
    order = sorted(range(len(configs)),
                   key=lambda i: _objective_vector(configs[i]))
    front: list[int] = []
    pts = [_objective_vector(c) for c in configs]
    for i in order:
        p = pts[i]
        if any(all(x <= y for x, y in zip(pts[j], p)) and pts[j] != p
               for j in front):
            continue
        front.append(i)
    return [configs[i] for i in front]


# ---------------------------------------------------------------------------
# DP lattice (beyond-paper exact search + k-best)
# ---------------------------------------------------------------------------

class Constraints:
    """Hard constraints on the partitioning search (Scission Step 6).

    **All constraints are exact in every strategy** — the exhaustive
    enumeration filters whole configs, and the lattices fold each kind
    into the DP itself:

    * ``must_use`` — via the used-resource bit mask on the state.
    * ``exclude`` / ``pin`` — via :meth:`allowed` on states.
    * ``max_link_bytes`` — via :meth:`transition_allowed` on hand-offs.
    * ``max_resource_time`` — cap on a resource's total compute time.
      Strict tier ordering means a path visits each resource at most once,
      as one contiguous segment, so the "path-dependent" accumulated time
      is just the open segment's span: the lattices carry the open
      segment's start block in the state key for capped resources and
      prune any extension whose segment time exceeds the cap in-flight.
    * ``min_blocks_on`` — floor on the number of blocks a resource hosts
      (a floor >= 1 also forces the resource to appear, so it joins the
      must-use mask); enforced exactly when the segment closes.

    The two path-dependent kinds used to be enforced by post-filtering
    k-best pools, so a binding constraint could reject every pooled winner
    and return fewer — or zero — results while a feasible optimum existed.
    :meth:`path_feasible` remains as the whole-config reference check used
    by the exhaustive strategy (and as the validation oracle in tests).
    """

    def __init__(self,
                 must_use: Sequence[str] = (),
                 exclude: Sequence[str] = (),
                 pin: dict[int, str] | None = None,
                 max_link_bytes: dict[tuple[str, str], float] | None = None,
                 max_resource_time: dict[str, float] | None = None,
                 min_blocks_on: dict[str, int] | None = None):
        self.must_use = tuple(must_use)
        self.exclude = frozenset(exclude)
        self.pin = dict(pin or {})
        self.max_link_bytes = dict(max_link_bytes or {})
        self.max_resource_time = dict(max_resource_time or {})
        self.min_blocks_on = dict(min_blocks_on or {})

    def allowed(self, block: int, resource: str) -> bool:
        if resource in self.exclude:
            return False
        pinned = self.pin.get(block)
        return pinned is None or pinned == resource

    def transition_allowed(self, src: str, dst: str, nbytes: float) -> bool:
        limit = self.max_link_bytes.get((src, dst))
        return limit is None or nbytes <= limit

    def path_feasible(self, cfg: PartitionConfig) -> bool:
        """Whole-config check of the path-dependent constraints — used by
        the exhaustive strategy's filter and as the lattices' validation
        oracle (the lattices themselves enforce these in the DP state)."""
        for res, tmax in self.max_resource_time.items():
            if cfg.compute_s.get(res, 0.0) > tmax:
                return False
        for res, nmin in self.min_blocks_on.items():
            got = sum(s.end - s.start + 1 for s in cfg.segments
                      if s.resource == res)
            if got < nmin:
                return False
        return True


class _LatticeBase:
    """State shared by every lattice DP: the exclude-filtered resource
    list, tier ordering, the must-use bit mask, and the in-DP form of the
    path-dependent constraints.

    A ``must_use`` entry (or a ``min_blocks_on`` floor >= 1, which demands
    presence) naming a resource that is unknown or excluded is
    **unsatisfiable**: no path can ever visit it, so ``infeasible`` is set
    and every ``solve`` returns ``[]`` — exactly what the exhaustive
    strategy does (it rejects every config), keeping the strategies
    consistent instead of silently dropping the constraint.

    Path-dependent constraints are exact in the DP because transitions
    only move to strictly later tiers: a path visits each resource at most
    once, as one contiguous segment, so a resource's total compute time
    and block count are properties of that single segment.  A lattice that
    works at block granularity carries the open segment's start block in
    its state key — but only for **tracked** resources (those named by
    ``max_resource_time`` / ``min_blocks_on``), so the state space is
    unchanged when the constraints are absent.  ``_seg_ok`` prunes a
    segment that exceeds its compute-time cap the moment it does (the cap
    is monotone in the segment span), and ``_close_ok`` enforces the
    min-block floor when the segment closes.  Both recompute the segment
    time via ``CostModel.segment_time``, the same prefix-sum arithmetic
    ``evaluate`` uses, so the DP and the exhaustive oracle agree bit for
    bit on feasibility.
    """

    def __init__(self, cost: CostModel,
                 constraints: Constraints | None = None,
                 plan: "ChainPlan | None" = None):
        self.cost = cost
        self.cons = constraints or Constraints()
        self.res = [r for r in cost.resources
                    if r.name not in self.cons.exclude]
        self.names = [r.name for r in self.res]
        self.order = {r.name: r.order for r in self.res}
        self.tmax = dict(self.cons.max_resource_time)
        # a floor <= 0 is trivially satisfied (path_feasible accepts even
        # an absent resource); a floor >= 1 demands presence
        self.nmin = {n: k for n, k in self.cons.min_blocks_on.items()
                     if k >= 1}
        demanded = list(dict.fromkeys((*self.cons.must_use, *self.nmin)))
        self.must = [n for n in demanded if n in self.names]
        self.must_idx = {n: i for i, n in enumerate(self.must)}
        self.full_mask = (1 << len(self.must)) - 1
        self.infeasible = (
            any(n not in self.names for n in demanded)
            or any(k > cost.n_blocks for k in self.nmin.values()))
        # a caller-supplied ChainPlan (batch-independent solve structure,
        # see ChainPlan) is adopted only when it was built over the same
        # resource axis — the engine keys its plan cache by the constraint
        # signature, so a matching axis implies matching matrices
        if plan is not None and plan.names == self.names:
            self._plan = plan

    def _bit(self, resource: str) -> int:
        i = self.must_idx.get(resource)
        return 0 if i is None else 1 << i

    def _mask_with(self, mask: int, resource: str) -> int:
        return mask | self._bit(resource)

    def _tracked(self, resource: str) -> bool:
        """True when the open segment's start block must live in the state
        key for ``resource`` (it is compute-time capped or block-floored)."""
        return resource in self.tmax or resource in self.nmin

    def _seg_ok(self, resource: str, start: int, end: int) -> bool:
        """Segment ``start..end`` on ``resource`` within its compute-time
        cap (trivially true for uncapped resources)."""
        t = self.tmax.get(resource)
        return t is None or \
            self.cost.segment_time(resource, start, end) <= t

    def _close_ok(self, resource: str, start: int, end: int) -> bool:
        """Closing segment ``start..end`` on ``resource`` satisfies its
        min-block floor (the time cap was enforced while it grew)."""
        k = self.nmin.get(resource)
        return k is None or end - start + 1 >= k

    def _get_plan(self) -> "ChainPlan":
        plan = getattr(self, "_plan", None)
        if plan is None:
            plan = self._plan = ChainPlan(self.cost, base=self)
        return plan


class ChainPlan:
    """Batch-independent structure of a chain-lattice solve.

    Everything a chain DP transition needs that does *not* depend on the
    operating point: the exclude-filtered resource axis, the tier-order
    transition matrix, per-block ``allowed`` masks, link latency /
    bandwidth / byte-limit matrices, and the vectorised forms of the in-DP
    constraints.  One plan is shared across a whole
    ``QueryEngine.frontier()`` operating-point sweep (solve structure
    once, re-price per batch) and across elastic re-plans; per-batch
    numeric tables (block times, output bytes, replica divisors) stay in
    the per-solve ``_tables``.
    """

    def __init__(self, cost: CostModel,
                 constraints: Constraints | None = None,
                 base: _LatticeBase | None = None):
        if base is None:
            base = _LatticeBase(cost, constraints)
        self.cons = base.cons
        self.names = list(base.names)
        self.must = list(base.must)
        self.full_mask = base.full_mask
        self.infeasible = base.infeasible
        R = len(self.names)
        B = cost.n_blocks
        self.R, self.B = R, B
        self.tracked = np.array([base._tracked(n) for n in self.names],
                                dtype=bool)
        self.tmaxv = np.array([base.tmax.get(n, math.inf)
                               for n in self.names])
        self.nminv = np.array([base.nmin.get(n, 0) for n in self.names],
                              dtype=np.int64)
        self.bitv = np.array([base._bit(n) for n in self.names],
                             dtype=np.int64)
        self.allowed = np.array(
            [[self.cons.allowed(b, n) for n in self.names]
             for b in range(B)], dtype=bool)
        ordv = np.array([base.order[n] for n in self.names])
        # [i, j] == a hand-off i -> j moves to a strictly later tier
        self.ok_pair = ordv[None, :] > ordv[:, None]
        lat = np.zeros((R, R))
        bw = np.full((R, R), math.inf)
        for i, a in enumerate(self.names):
            for j, b2 in enumerate(self.names):
                if i == j:
                    continue
                lnk = cost.network.link(a, b2)
                lat[i, j] = lnk.latency_s
                bw[i, j] = lnk.bandwidth
        self.latm, self.bwm = lat, bw
        lim = np.full((R, R), math.inf)
        idx = {n: i for i, n in enumerate(self.names)}
        for (a, b2), v in self.cons.max_link_bytes.items():
            if a in idx and b2 in idx:
                lim[idx[a], idx[b2]] = v
        self.limitm = lim


class PartitionLattice(_LatticeBase):
    """Viterbi over (block, resource, used-mask) with k-best extraction.

    Transitions: stay on the same resource (free) or hand off to a strictly
    later tier (pay ``comm(out_bytes[block])``).  The used-mask tracks which
    must-use resources have been visited so 'entire pipeline' style
    constraints stay exact, and for resources named by the path-dependent
    constraints the state key additionally carries the open segment's start
    block (see ``_LatticeBase``), so ``max_resource_time`` prunes in-flight
    and ``min_blocks_on`` gates segment closes — every constraint is part
    of the DP state and ``solve`` returns the true constrained k-best, with
    no post-filtering.
    """

    labels_kept = 0
    labels_pruned = 0

    def __init__(self, cost: CostModel, constraints: Constraints | None = None,
                 objective: Objective = LATENCY,
                 plan: "ChainPlan | None" = None):
        super().__init__(cost, constraints, plan=plan)
        self.obj = objective

    def _step_cost(self, resource: str, block: int) -> float:
        t = self.cost.segment_time(resource, block, block)
        return self.obj.w_latency * t

    def _comm_cost(self, src: str, dst: str, nbytes: float) -> float:
        return (self.obj.w_latency * self.cost.comm(src, dst, nbytes)
                + self.obj.w_transfer_per_mb * nbytes / 1e6)

    def solve(self, top_n: int = 1) -> list[PartitionConfig]:
        """k-best paths through the lattice; returns up to ``top_n`` feasible
        configs ranked by the objective.

        Every constraint lives in the DP state, so this is the exact
        constrained k-best: labels at the same (resource, mask, open-seg
        start) state are interchangeable prefixes for every feasible
        completion, hence ``K == top_n`` per state suffices and distinct
        entries reconstruct distinct configs (a path determines its state).

        Each block's labels live in flat arrays (score / resource / mask /
        open-seg start / parent row) and the per-state k-best cut is one
        :func:`grouped_topk` call — no per-label Python in the hot loop.
        """
        self.labels_kept = self.labels_pruned = 0
        if top_n <= 0 or self.infeasible:
            return []
        cost = self.cost
        plan = self._get_plan()
        B, R = plan.B, plan.R
        K = top_n
        rsel = [cost._idx[n] for n in plan.names]
        cum = cost.cum[rsel]
        steps = np.ascontiguousarray((cum[:, 1:] - cum[:, :-1]).T)  # (B, R)
        wsteps = self.obj.w_latency * steps
        wtr = self.obj.w_transfer_per_mb

        # block 0 (scalar: one row per feasible start resource)
        rows = []
        for j, r in enumerate(plan.names):
            if not plan.allowed[0, j] or not (steps[0, j] <= plan.tmaxv[j]):
                continue
            inp = 0.0
            if r != cost.source:
                nbytes = cost.batch_input_bytes
                if not plan.cons.transition_allowed(cost.source, r, nbytes):
                    continue
                inp = self._comm_cost(cost.source, r, nbytes)
            rows.append((inp + wsteps[0, j], j))
        score = np.array([x[0] for x in rows])
        rix = np.array([x[1] for x in rows], dtype=np.int64)
        msk = plan.bitv[rix]
        sta = np.where(plan.tracked[rix], 0, -1) if len(rix) else \
            np.zeros(0, dtype=np.int64)
        par = np.full(len(rix), -1, dtype=np.int64)
        blocks = [{"rix": rix, "par": par}]

        for b in range(1, B):
            nbytes = float(cost.out_bytes[b - 1])
            steps_b = steps[b]
            # stay: the open segment grows through block b (pruned the
            # moment it would exceed its compute-time cap)
            ok = plan.allowed[b][rix].copy()
            tr = np.flatnonzero(ok & (sta >= 0))
            if len(tr):
                segt = cum[rix[tr], b + 1] - cum[rix[tr], sta[tr]]
                ok[tr] &= segt <= plan.tmaxv[rix[tr]]
            stay = np.flatnonzero(ok)
            # hand off to a later tier: closes [start..b-1] on r, which
            # must meet r's min-block floor
            close = (sta < 0) | ((b - sta) >= plan.nminv[rix])
            src = np.flatnonzero(close)
            tmask = plan.allowed[b] & (steps_b <= plan.tmaxv)
            pair = plan.ok_pair & (nbytes <= plan.limitm) & tmask[None, :]
            si_l, tj = np.nonzero(pair[rix[src]])
            si = src[si_l]
            hopm = (self.obj.w_latency * (plan.latm + nbytes / plan.bwm)
                    + wtr * nbytes / 1e6) + wsteps[b][None, :]
            c_score = np.concatenate(
                [score[stay] + wsteps[b, rix[stay]],
                 score[si] + hopm[rix[si], tj]])
            c_rix = np.concatenate([rix[stay], tj])
            c_msk = np.concatenate([msk[stay], msk[si] | plan.bitv[tj]])
            c_sta = np.concatenate(
                [sta[stay], np.where(plan.tracked[tj], b, -1)])
            c_par = np.concatenate([stay, si])
            key = ((c_rix * np.int64(plan.full_mask + 1) + c_msk)
                   * np.int64(B + 2) + (c_sta + 1))
            keep = grouped_topk(key, c_score, K)
            self.labels_kept += len(keep)
            self.labels_pruned += len(c_score) - len(keep)
            score, rix, msk, sta, par = (c_score[keep], c_rix[keep],
                                         c_msk[keep], c_sta[keep],
                                         c_par[keep])
            blocks.append({"rix": rix, "par": par})

        fin = (msk == plan.full_mask) & \
            ((sta < 0) | ((B - sta) >= plan.nminv[rix]))
        order = np.argsort(score[np.flatnonzero(fin)], kind="stable")
        finals = np.flatnonzero(fin)[order]
        out: list[PartitionConfig] = []
        seen: set[tuple[Segment, ...]] = set()
        for i in finals:
            segs = _walk_path(blocks, int(i), plan.names)
            if segs in seen:
                continue
            seen.add(segs)
            out.append(cost.evaluate(segs))
            if len(out) >= top_n:
                break
        return out


def _walk_path(blocks: list[dict], i: int,
               names: list[str]) -> tuple[Segment, ...]:
    """Follow parent rows from row ``i`` of the last block back to block 0
    and fold the resource path into contiguous segments."""
    path: list[str] = []
    for b in range(len(blocks) - 1, -1, -1):
        blk = blocks[b]
        path.append(names[blk["rix"][i]])
        i = int(blk["par"][i])
    path.reverse()
    segs: list[Segment] = []
    start = 0
    for k in range(1, len(path) + 1):
        if k == len(path) or path[k] != path[start]:
            segs.append(Segment(path[start], start, k - 1))
            start = k
    return tuple(segs)


class BottleneckLattice(_LatticeBase):
    """Exact min-bottleneck (max-throughput) DP — the minimax companion to
    :class:`PartitionLattice`.

    Under pipelined serving the objective is ``max`` over *effective* stage
    periods (replica- and batch-adjusted compute, per-request comm), which
    is not additive, so the Viterbi lattice's sum-composition is not exact.
    This DP works at *segment* granularity:

        f(b, r, need) = k-best achievable bottlenecks over blocks b..B-1
                        when block b starts a new segment on resource r and
                        ``need`` is the set of must-use resources still owed

    with minimax composition ``max(stage_period, hop_period, child)``.  Max
    is monotone in the child value, so k-best per state is exact; replicas
    and batch only rescale each state's local cost (the cost model's
    ``stage_period`` / ``hop_period``), so the DP stays exact at every
    operating point.  Complexity O(B²·R²·K·2^M) for M must-use resources.

    Because this DP works at whole-segment granularity, the path-dependent
    constraints need **no state extension at all**: every transition (and
    every terminal) names its segment's exact extent, so
    ``max_resource_time`` and ``min_blocks_on`` are checked per transition
    (``_seg_ok`` / ``_close_ok``) and infeasible segments never enter the
    lattice — ``solve`` returns the true constrained optimum with no
    post-filtering and no pool widening.

    Ties on the bottleneck value are broken by end-to-end latency across
    the *entire* reconstruction pool (every tied final is reconstructed
    before truncating to ``top_n``).  A tie wider than a single state's
    k-best pool can still be cut *inside* the DP; the solver detects that
    (a state dropped a candidate whose value ties the returned optimum)
    and reconstructs the exact tied surface via :class:`ParetoLattice`
    dispatch — the minimum (bottleneck, latency) point is always on the
    Pareto frontier — so the returned optimum's latency tie-break is exact
    regardless of pool width.
    """

    # introspection state of the last solve (class-level defaults so an
    # early-returning solve — infeasible / top_n <= 0 — reads as no-op)
    _tie_cut = math.inf
    _dispatched = False
    labels_kept = 0
    labels_pruned = 0

    def solve(self, top_n: int = 1) -> list[PartitionConfig]:
        if top_n <= 0 or self.infeasible:
            return []
        B = self.cost.n_blocks
        # K == top_n is exact for the k-best *values*; the +head-room keeps
        # more bottleneck-tied candidates in the pools so the latency
        # tie-break rarely has to fall back to the Pareto dispatch below
        K = max(top_n * 2, top_n + 2)
        self._tie_cut = math.inf       # min value a full pool ever dropped
        names = self.names
        out_bytes = self.cost.out_bytes
        # longest allowed contiguous run starting at each (resource, block)
        run: dict[str, list[int]] = {}
        for r in names:
            ok = [self.cons.allowed(b, r) for b in range(B)]
            ends = [0] * (B + 1)
            for b in range(B - 1, -1, -1):
                ends[b] = ends[b + 1] + 1 if ok[b] else 0
            run[r] = ends[:B]

        # memo[(b, ri, need)] = up to K (value, end, child_key, child_pos),
        # sorted ascending; ``need`` never contains ri's own bit.  VAL is
        # the same pools as padded value arrays: the candidate merge below
        # gathers every child pool of a state in one fancy index and sorts
        # the max-composed values in one stable argsort — only the <= K
        # surviving entries are materialised as Python tuples.
        memo: dict[tuple[int, int, int], list[tuple]] = {}
        self.labels_kept = self.labels_pruned = 0
        FM = self.full_mask + 1
        VAL = np.full((B, len(names), FM, K), math.inf)
        for b in range(B - 1, -1, -1):
            for ri, r in enumerate(names):
                n_run = run[r][b]
                bit_r = self._bit(r)
                # transitions are independent of the must-use mask — hoist
                # the (end, r2) scan out of the need loop.  Constraints on
                # the segment itself (compute-time cap, min-block floor)
                # are exact here: each candidate names its segment extent.
                term = None
                if b + n_run >= B and self._seg_ok(r, b, B - 1) \
                        and self._close_ok(r, b, B - 1):
                    term = self.cost.stage_period(r, b, B - 1)
                trans: list[tuple] = []      # (base, end, rj, clear_bit)
                for end in range(b, min(b + n_run, B - 1)):
                    if not self._seg_ok(r, b, end):
                        break            # segment time is monotone in end
                    if not self._close_ok(r, b, end):
                        continue
                    nbytes = float(out_bytes[end])
                    seg_t = self.cost.stage_period(r, b, end)
                    for rj, r2 in enumerate(names):
                        if self.order[r2] <= self.order[r] or \
                                not self.cons.transition_allowed(
                                    r, r2, nbytes):
                            continue
                        base = max(seg_t, self.cost.hop_period(r, r2, nbytes))
                        trans.append((base, end, rj, ~self._bit(r2)))
                if trans:
                    basev = np.array([t[0] for t in trans])
                    endv = np.array([t[1] for t in trans], dtype=np.intp)
                    rjv = np.array([t[2] for t in trans], dtype=np.intp)
                    clearv = np.array([t[3] for t in trans], dtype=np.int64)
                for need in range(FM):
                    if need & bit_r:
                        continue
                    has_term = term is not None and need == 0
                    if not trans:
                        ents = [(term, B - 1, None, -1)] if has_term else []
                        memo[(b, ri, need)] = ents
                        if ents:
                            VAL[b, ri, need, 0] = term
                        self.labels_kept += len(ents)
                        continue
                    # candidate values: term first, then trans-major /
                    # child-pos-minor — the exact order the scalar merge
                    # appended them in, so the stable sort breaks value
                    # ties identically; inf padding sorts to the end
                    flat = np.maximum(basev[:, None],
                                      VAL[endv + 1, rjv,
                                          need & clearv]).ravel()
                    off = 0
                    if has_term:
                        flat = np.concatenate([[term], flat])
                        off = 1
                    order = np.argsort(flat, kind="stable")
                    vals = flat[order]
                    n_real = int(np.searchsorted(vals, math.inf))
                    if n_real > K:
                        self._tie_cut = min(self._tie_cut, float(vals[K]))
                    k = min(K, n_real)
                    ents = []
                    for fi in order[:k]:
                        if has_term and fi == 0:
                            ents.append((term, B - 1, None, -1))
                            continue
                        ti, pos = divmod(int(fi) - off, K)
                        ck = (int(endv[ti]) + 1, int(rjv[ti]),
                              need & int(clearv[ti]))
                        ents.append((float(flat[fi]), int(endv[ti]),
                                     ck, pos))
                    memo[(b, ri, need)] = ents
                    VAL[b, ri, need, :k] = vals[:k]
                    self.labels_kept += k
                    self.labels_pruned += n_real - k

        finals: list[tuple[float, tuple[int, int, int], int]] = []
        for ri, r in enumerate(names):
            key = (0, ri, self.full_mask & ~self._bit(r))
            entries = memo.get(key)
            if not entries:
                continue
            inp = 0.0
            if r != self.cost.source:
                nbytes = self.cost.batch_input_bytes
                if not self.cons.transition_allowed(
                        self.cost.source, r, nbytes):
                    continue
                inp = self.cost.hop_period(self.cost.source, r, nbytes)
            for pos in range(len(entries)):
                finals.append((max(entries[pos][0], inp), key, pos))
        finals.sort(key=lambda t: t[0])

        # ties in bottleneck are common (e.g. the input hop dominates), so
        # truncating the reconstruction pool before the (bottleneck,
        # latency) tie-break could cut a lower-latency config and return a
        # strictly worse one.  Reconstruct until we hold top_n configs AND
        # the next candidate's value exceeds the top_n-th best bottleneck —
        # i.e. collect every bottleneck-tied candidate first.
        out: list[PartitionConfig] = []
        seen: set[tuple[Segment, ...]] = set()
        kth = math.inf                  # top_n-th smallest kept bottleneck
        for val, key, pos in finals:
            if len(out) >= top_n and val > kth * (1 + 1e-12) + 1e-18:
                break
            segs = self._reconstruct(memo, key, pos)
            if segs in seen:
                continue
            seen.add(segs)
            out.append(self.cost.evaluate(segs))
            if len(out) >= top_n:
                kth = sorted(c.bottleneck_s for c in out)[top_n - 1]
        win = min((c.bottleneck_s for c in out), default=math.inf)
        tol = win * (1 + 1e-12) + 1e-18
        n_tied = sum(1 for c in out if c.bottleneck_s <= tol)
        out.sort(key=lambda c: (c.bottleneck_s, c.latency_s))
        out = out[:top_n]

        # a full pool dropped a candidate that could tie the winner AND
        # the winner genuinely ties (if a cut path tied the winner, at
        # least two kept finals tie it too: swapping a dropped entry for a
        # kept sibling only lowers the max-composed value, which cannot go
        # below the global minimum — so a unique winner proves no tie was
        # cut).  Only then is the tied surface possibly wider than the
        # pools: reconstruct it exactly via ParetoLattice (the
        # min-(bottleneck, latency) point is always on the Pareto
        # frontier) and let it lead the ranking.  The double condition
        # keeps this dispatch off the common no-tie path — suffix values
        # exclude the prefix/input-hop floor, so ``_tie_cut`` alone
        # under-estimates wildly and would fire on almost every solve.
        self._dispatched = bool(out and n_tied >= 2
                                and self._tie_cut <= tol)
        if self._dispatched:
            best = self._tied_surface_best(out[0].bottleneck_s)
            if best is not None and best.segments not in seen:
                out = [best, *out]
                out.sort(key=lambda c: (c.bottleneck_s, c.latency_s))
                out = out[:top_n]
        return out

    def _tied_surface_best(self, value: float) -> PartitionConfig | None:
        """Exact min-(bottleneck, latency, transfer) config among those
        whose bottleneck ties ``value``, via the Pareto frontier (which
        always carries that point)."""
        tol = value * (1 + 1e-12) + 1e-18
        tied = [c for c in ParetoLattice(self.cost, self.cons).solve()
                if c.bottleneck_s <= tol]
        if not tied:
            return None
        return min(tied, key=lambda c: (c.bottleneck_s, c.latency_s,
                                        c.transfer_bytes))

    def _reconstruct(self, memo, key, pos) -> tuple[Segment, ...]:
        segs: list[Segment] = []
        start = key[0]
        while True:
            value, end, child_key, child_pos = memo[key][pos]
            segs.append(Segment(self.names[key[1]], start, end))
            if child_key is None:
                return tuple(segs)
            key, pos, start = child_key, child_pos, end + 1


# the dominance kernel lives in .labelset (vectorised, with a retained
# scalar reference for the property tests); the historical name is kept —
# the repro_torch.core.partition shim and several tests import it from here
_nondominated_rows = nondominated_rows


class ParetoLattice(_LatticeBase):
    """Exact Pareto-frontier extraction over (latency, bottleneck, transfer).

    A label-correcting DP over the same (block, resource, must-use-mask)
    states as :class:`PartitionLattice`, except each state keeps its full
    **non-dominated set** of vector labels

        (latency_so_far, bottleneck_of_closed_stages, transfer_so_far,
         open_segment_time)

    instead of a scalar k-best list.  Latency and transfer compose
    additively, the closed-stage bottleneck by minimax, and the open
    segment's eventual stage period is monotone in its accumulated time —
    all monotone operators — so per-state dominance pruning is exact: no
    genuinely non-dominated operating point can be lost, which the
    three-objective k-best union used by ``QueryEngine.frontier`` before
    this class could not guarantee.  Distinct paths with identical labels
    collapse to one representative, so the result carries one config per
    frontier *vector* (the exhaustive oracle may hold several tied
    configs with equal objectives).

    ``epsilon`` > 0 enables multiplicative ε-dominance pruning to bound
    label-set growth on fleet-sized spaces: a label is also dropped when a
    kept label is within a factor (1+ε) in every component.  Relative
    error composes through the additive/minimax operators, so every
    exact-front point has a returned point within (1+ε)^S of it in every
    objective (S = blocks on the path; far tighter in practice).  The
    default 0.0 is exact.  ``labels_kept`` / ``labels_pruned`` record the
    label-set statistics across all states of the last :meth:`solve`.

    Constraints: ``must_use`` (via the mask), ``exclude``/``pin`` (via
    ``allowed``) and ``max_link_bytes`` (via ``transition_allowed``) are
    exact in the DP, and so are the path-dependent ``max_resource_time`` /
    ``min_blocks_on``: for resources they name, the state key carries the
    open segment's start block (see ``_LatticeBase``), so over-cap
    extensions are pruned the moment they occur and under-floor segment
    closes are rejected — labels within a state remain interchangeable
    prefixes and dominance pruning stays exact.  The split states' label
    sets rejoin in the global non-dominated filter over completed vectors,
    so the returned frontier is the true constrained frontier with no
    post-filtering (the exhaustive strategy remains the validation
    oracle).
    """

    def __init__(self, cost: CostModel,
                 constraints: Constraints | None = None,
                 epsilon: float = 0.0,
                 plan: ChainPlan | None = None):
        if epsilon < 0.0:
            raise ValueError(f"epsilon must be >= 0, got {epsilon}")
        super().__init__(cost, constraints)
        self.epsilon = float(epsilon)
        self.labels_kept = 0
        self.labels_pruned = 0
        self.state: LabelState | None = None
        if plan is not None and plan.names == self.names:
            self._plan = plan

    def _div(self, resource: str) -> float:
        """Per-request divisor of a compute stage on ``resource`` — the
        label's open-segment time over this is its eventual stage period."""
        return self.cost.replicas_for(resource) * self.cost.batch_size

    # -- per-solve numeric tables (operating-point dependent) --------------
    def _tables(self) -> dict:
        cost, plan = self.cost, self._get_plan()
        rsel = [cost._idx[n] for n in plan.names]
        cum = cost.cum[rsel]
        # per-block times as prefix-sum differences — the exact arithmetic
        # of CostModel.segment_time, so feasibility and label values agree
        # bit for bit with the scalar path and the exhaustive oracle
        steps = np.ascontiguousarray((cum[:, 1:] - cum[:, :-1]).T)  # (B, R)
        div = np.array([cost.replicas_for(n) * cost.batch_size
                        for n in plan.names], dtype=np.float64)
        return {"cum": cum, "steps": steps, "div": div,
                "out": cost.out_bytes}

    def _init_block(self, tbl: dict, only=None) -> dict:
        """Block-0 label rows (``only`` restricts the start resources — the
        join-delta path seeds starts on joined resources alone)."""
        cost, plan = self.cost, self._get_plan()
        rows = []
        for j in (range(plan.R) if only is None else only):
            r = plan.names[j]
            if not plan.allowed[0, j] or \
                    not (tbl["steps"][0, j] <= plan.tmaxv[j]):
                continue
            lat = bneck = xfer = 0.0
            if r != cost.source:
                nbytes = cost.batch_input_bytes
                if not plan.cons.transition_allowed(cost.source, r, nbytes):
                    continue
                lat = cost.comm(cost.source, r, nbytes)
                bneck = cost.hop_period(cost.source, r, nbytes)
                xfer = nbytes
            step = float(tbl["steps"][0, j])
            rows.append((lat + step, bneck, xfer, step, j))
        lab = np.array([x[:4] for x in rows],
                       dtype=np.float64).reshape(-1, 4)
        rix = np.array([x[4] for x in rows], dtype=np.int64)
        return {"lab": lab, "rix": rix, "msk": plan.bitv[rix],
                "sta": np.where(plan.tracked[rix], 0, -1).astype(np.int64),
                "par": np.full(len(rix), -1, dtype=np.int64),
                "used": np.int64(1) << rix}

    def _advance(self, prev: dict, b: int, tbl: dict,
                 delta_from: int = 0, joined=None,
                 protect: dict | None = None) -> dict:
        """One fused extend-then-prune step: all candidate labels of block
        ``b`` from the rows of block ``b - 1``, pruned per state in one
        :func:`grouped_nondominated` call.

        ``delta_from`` / ``joined`` / ``protect`` serve the incremental
        join path: rows of ``prev`` below ``delta_from`` are replayed old
        rows — they do not stay (their extensions are already in
        ``protect``, the old rows of block ``b``) and hand off only into
        ``joined`` resource columns; ``protect`` rows are prepended
        unprunable and only the delta candidates compete against them.
        """
        cost, plan = self.cost, self._get_plan()
        lab, rix, msk, sta, used = (prev["lab"], prev["rix"], prev["msk"],
                                    prev["sta"], prev["used"])
        steps_b = tbl["steps"][b]
        cum = tbl["cum"]
        nbytes = float(tbl["out"][b - 1])
        # stay: the open segment grows through block b (pruned the moment
        # it would exceed its compute-time cap)
        ok = plan.allowed[b][rix].copy()
        if delta_from:
            ok[:delta_from] = False
        tr = np.flatnonzero(ok & (sta >= 0))
        if len(tr):
            segt = cum[rix[tr], b + 1] - cum[rix[tr], sta[tr]]
            ok[tr] &= segt <= plan.tmaxv[rix[tr]]
        stay = np.flatnonzero(ok)
        s_lab = lab[stay].copy()
        sv = steps_b[rix[stay]]
        s_lab[:, 0] += sv
        s_lab[:, 3] += sv
        # hand off: closes [sta..b-1] (min-block floor) and opens block b
        # on a strictly later tier
        close = (sta < 0) | ((b - sta) >= plan.nminv[rix])
        src = np.flatnonzero(close)
        tmask = plan.allowed[b] & (steps_b <= plan.tmaxv)
        pair = plan.ok_pair & (nbytes <= plan.limitm) & tmask[None, :]
        mat = pair[rix[src]]
        if delta_from and joined is not None:
            jm = np.zeros(plan.R, dtype=bool)
            jm[joined] = True
            mat[src < delta_from] &= jm[None, :]
        si_l, tj = np.nonzero(mat)
        si = src[si_l]
        rs = rix[si]
        hopc = plan.latm + nbytes / plan.bwm
        hs = hopc + steps_b[None, :]
        hopp = hopc / cost.batch_size
        h_lab = np.empty((len(si), 4))
        h_lab[:, 0] = lab[si, 0] + hs[rs, tj]
        h_lab[:, 1] = np.maximum(
            np.maximum(lab[si, 1], lab[si, 3] / tbl["div"][rs]),
            hopp[rs, tj])
        h_lab[:, 2] = lab[si, 2] + nbytes
        h_lab[:, 3] = steps_b[tj]
        c_lab = np.concatenate([s_lab, h_lab])
        c_rix = np.concatenate([rix[stay], tj])
        c_msk = np.concatenate([msk[stay], msk[si] | plan.bitv[tj]])
        c_sta = np.concatenate(
            [sta[stay], np.where(plan.tracked[tj], b, -1)]).astype(np.int64)
        c_par = np.concatenate([stay, si])
        c_used = np.concatenate([used[stay],
                                 used[si] | (np.int64(1) << tj)])
        nprot = 0 if protect is None else len(protect["lab"])
        if nprot:
            key = (((np.concatenate([protect["rix"], c_rix])
                     * np.int64(plan.full_mask + 1))
                    + np.concatenate([protect["msk"], c_msk]))
                   * np.int64(plan.B + 2)
                   + (np.concatenate([protect["sta"], c_sta]) + 1))
            keep = grouped_nondominated(
                np.concatenate([protect["lab"], c_lab]), key, self.epsilon)
            keep = keep[keep >= nprot] - nprot   # delta survivors only
        else:
            key = ((c_rix * np.int64(plan.full_mask + 1) + c_msk)
                   * np.int64(plan.B + 2) + (c_sta + 1))
            keep = grouped_nondominated(c_lab, key, self.epsilon)
        self.labels_kept += len(keep)
        self.labels_pruned += len(c_lab) - len(keep)
        blk = {"lab": c_lab[keep], "rix": c_rix[keep], "msk": c_msk[keep],
               "sta": c_sta[keep], "par": c_par[keep], "used": c_used[keep]}
        if nprot:
            blk = _concat_blocks(protect, blk)
        return blk

    def _finish(self, blocks: list[dict],
                tbl: dict) -> list[PartitionConfig]:
        """Close every final open segment, filter the completed vectors
        globally (states split by open-seg start rejoin here), and price
        the surviving paths through ``CostModel.evaluate`` — the single
        source of truth for the objective vectors."""
        cost, plan = self.cost, self._get_plan()
        last = blocks[-1]
        lab, rix, msk, sta = (last["lab"], last["rix"], last["msk"],
                              last["sta"])
        B = plan.B
        fin = (msk == plan.full_mask) & \
            ((sta < 0) | ((B - sta) >= plan.nminv[rix]))
        rows = np.flatnonzero(fin)
        if not len(rows):
            return []
        vec = np.empty((len(rows), 3))
        vec[:, 0] = lab[rows, 0]
        vec[:, 1] = np.maximum(lab[rows, 1],
                               lab[rows, 3] / tbl["div"][rix[rows]])
        vec[:, 2] = lab[rows, 2]
        keep = nondominated_rows(vec, 0.0)
        out: list[PartitionConfig] = []
        seen: set[tuple[Segment, ...]] = set()
        for i in rows[keep]:
            segs = _walk_path(blocks, int(i), plan.names)
            if segs in seen:
                continue
            seen.add(segs)
            out.append(cost.evaluate(segs))
        out = pareto_frontier(out)
        out.sort(key=lambda c: (c.latency_s, c.bottleneck_s,
                                c.transfer_bytes))
        return out

    def solve(self, keep_state: bool = False) -> list[PartitionConfig]:
        """The exact (ε = 0) non-dominated set of configurations, sorted by
        (latency, bottleneck, transfer).

        ``keep_state=True`` additionally retains the per-block label
        arrays on ``self.state`` for incremental elastic re-plans
        (:meth:`resume` / :meth:`extend`)."""
        plan = self._get_plan()
        self.labels_kept = self.labels_pruned = 0
        self.state = None
        if plan.infeasible:
            return []
        tbl = self._tables()
        blocks = [self._init_block(tbl)]
        for b in range(1, plan.B):
            blocks.append(self._advance(blocks[-1], b, tbl))
        out = self._finish(blocks, tbl)
        if keep_state:
            self.state = LabelState(list(plan.names), list(plan.must),
                                    self.epsilon, blocks, out,
                                    plan.R <= _MAX_INC_RESOURCES)
        return out

    # -- incremental elastic re-plans --------------------------------------
    def resume(self, prev: "LabelState",
               keep_state: bool = False) -> list[PartitionConfig]:
        """Warm re-solve after resources *left* the fleet.

        The kept label arrays of ``prev`` are replayed up to (excluding)
        the first block where any kept label's path ever touched a
        departed resource; the DP re-runs only from that frontier.  Exact
        at any ε: state keys name the current resource, so labels on
        surviving resources below that block were generated from — and
        pruned only against — labels on surviving resources, making the
        replayed prefix identical to a cold solve's.  Falls back to a
        cold solve when the state is unusable (different ε / must set /
        non-subset membership).
        """
        plan = self._get_plan()
        if (prev is None or not prev.supports_inc
                or self.epsilon != prev.epsilon
                or list(plan.must) != list(prev.must)
                or any(n not in prev.names for n in plan.names)):
            return self.solve(keep_state=keep_state)
        self.labels_kept = self.labels_pruned = 0
        self.state = None
        if plan.infeasible:
            return []
        pos = {n: i for i, n in enumerate(plan.names)}
        remap = np.array([pos.get(n, -1) for n in prev.names],
                         dtype=np.int64)
        lost = np.flatnonzero(remap < 0)
        lost_bits = np.int64(0)
        for i in lost:
            lost_bits |= np.int64(1) << np.int64(i)
        b0 = None
        for b, blk in enumerate(prev.blocks):
            if np.any(blk["used"] & lost_bits):
                b0 = b
                break
        if b0 == 0:
            return self.solve(keep_state=keep_state)
        tbl = self._tables()
        upto = len(prev.blocks) if b0 is None else b0
        blocks = [_remap_block(prev.blocks[b], remap, len(prev.names))
                  for b in range(upto)]
        if b0 is None:
            out = list(prev.configs)
        else:
            for b in range(b0, plan.B):
                blocks.append(self._advance(blocks[-1], b, tbl))
            out = self._finish(blocks, tbl)
        if keep_state:
            self.state = LabelState(list(plan.names), list(plan.must),
                                    self.epsilon, blocks, out,
                                    plan.R <= _MAX_INC_RESOURCES)
        return out

    def extend(self, prev: "LabelState",
               keep_state: bool = False) -> list[PartitionConfig]:
        """Warm re-solve after resources *joined* the fleet.

        Old kept rows are replayed verbatim as protected rows; only the
        delta — paths that visit a joined resource — is generated (old
        rows hand off into joined columns only, block-0 starts seed on
        joined resources only) and pruned against the protected rows.
        Output-exact at ε == 0: a protected row a delta row dominates
        yields only dominated completions, which the final global filter
        and the authoritative ``pareto_frontier`` re-filter remove; by
        dominance transitivity the delta prune loses nothing.  ε > 0
        falls back cold (the greedy archive is order-dependent).
        """
        plan = self._get_plan()
        if (prev is None or not prev.supports_inc
                or self.epsilon != 0.0 or prev.epsilon != 0.0
                or list(plan.must) != list(prev.must)
                or plan.names[:len(prev.names)] != list(prev.names)
                or plan.R > _MAX_INC_RESOURCES):
            return self.solve(keep_state=keep_state)
        self.labels_kept = self.labels_pruned = 0
        self.state = None
        if plan.infeasible:
            return []
        joined = np.arange(len(prev.names), plan.R)
        tbl = self._tables()
        blocks = [_concat_blocks(prev.blocks[0],
                                 self._init_block(tbl, only=joined))]
        for b in range(1, plan.B):
            blocks.append(self._advance(
                blocks[-1], b, tbl,
                delta_from=len(prev.blocks[b - 1]["lab"]),
                joined=joined, protect=prev.blocks[b]))
        out = self._finish(blocks, tbl)
        if keep_state:
            self.state = LabelState(list(plan.names), list(plan.must),
                                    self.epsilon, blocks, out,
                                    plan.R <= _MAX_INC_RESOURCES)
        return out


# used-resource bitmasks are int64: incremental state needs one bit per
# resource (fleets beyond this fall back to cold solves, which they would
# want anyway — the bigger the fleet, the higher the churn rate)
_MAX_INC_RESOURCES = 62


@dataclass
class LabelState:
    """Final per-block label arrays of one ``ParetoLattice.solve(
    keep_state=True)`` — what incremental elastic re-plans resume from.

    ``blocks[b]`` holds parallel arrays ``lab`` (N, 4 label columns),
    ``rix`` (resource index), ``msk`` (must-use mask), ``sta`` (open-seg
    start, -1 untracked), ``par`` (parent row in block b-1) and ``used``
    (bitmask over the resource axis of every resource on the row's path).
    """

    names: list[str]
    must: list[str]
    epsilon: float
    blocks: list[dict]
    configs: list[PartitionConfig]
    supports_inc: bool


def _concat_blocks(a: dict, b: dict) -> dict:
    return {k: np.concatenate([a[k], b[k]]) for k in a}


def _remap_block(blk: dict, remap: np.ndarray, n_old: int) -> dict:
    """Re-index a replayed block onto a shrunken resource axis (`remap`
    maps old resource index -> new, -1 for departed; no row of a replayed
    block touches a departed resource, so every lookup is valid)."""
    used = np.zeros_like(blk["used"])
    for i_old in range(n_old):
        i_new = remap[i_old]
        if i_new >= 0:
            used |= ((blk["used"] >> np.int64(i_old)) & np.int64(1)) \
                << np.int64(i_new)
    return {"lab": blk["lab"], "rix": remap[blk["rix"]], "msk": blk["msk"],
            "sta": blk["sta"], "par": blk["par"], "used": used}
