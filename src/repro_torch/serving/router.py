"""Frontier-placed request router: trace-driven admission, batching,
replica load balancing, and SLO shedding over a Scission operating point.

The router is the open-loop half of the serving story.  A **frontier
operating point** (a :class:`PartitionConfig`, e.g. one returned by
:meth:`QueryEngine.frontier`) fixes everything the request plane needs:

* the **admission width** — requests are formed into batches of
  ``point.batch_size``, the concurrency the cost model priced;
* the **stage pipeline** — input hop (if any), compute segments, comm
  hops, exactly the stage structure ``simulate_pipeline_throughput``
  uses;
* the **replica banks** — a compute stage with ``replicas[k]`` copies
  load-balances batches onto its least-loaded replica;
* the **SLO admission control** — a shadow walk of the pipeline (what
  would a batch dispatched now experience?) estimates a new arrival's
  completion time; arrivals whose estimate blows the SLO are shed at the
  front door, never mid-pipeline.

Time is **virtual**: arrivals carry trace offsets and service times come
from a :class:`Backend` — :class:`VirtualBackend` prices stages straight
from the operating point (so measured goodput is directly comparable to
the cost model's ``throughput_rps`` prediction), while
:class:`ExecutorBackend` measures them from a real
:class:`~repro_torch.runtime.pipeline.PipelineExecutor` over the model graph
(the runtime substrate behind the plane).  Either way the router's
queueing, batching, shedding and drain logic is identical.

Live re-planning: :meth:`Router.set_operating_point` swaps the operating
point mid-trace — in-flight batches drain to completion, then the plane
re-admits at the new width/replicas; nothing in flight is dropped.
:meth:`Router.on_plan` adapts an :class:`ElasticController` re-plan event
(``controller.add_listener(router.on_plan)`` wires controller re-plans
straight into the plane).
"""

from __future__ import annotations

from collections import Counter
from dataclasses import dataclass, field

from ..core.partition import PartitionConfig

from .metrics import PlaneReport, mean, percentile
from .requests import Arrival, empirical_rate


def stage_layout(point: PartitionConfig) -> list[tuple[str, float, int]]:
    """The pipeline stages of an operating point, in order:
    ``(kind, per-batch service time, replicas)`` with kind one of
    ``"input"`` / ``"compute"`` / ``"hop"``.  Hops are single-server (the
    link is the server) — the same structure
    :func:`~repro_torch.serving.sim.simulate_pipeline_throughput` walks."""
    stages: list[tuple[str, float, int]] = []
    if point.input_comm_s > 0.0:
        stages.append(("input", point.input_comm_s, 1))
    for k, t in enumerate(point.stage_compute_s):
        stages.append(("compute", t, point.replica_count(k)))
        if k < len(point.stage_comm_s):
            stages.append(("hop", point.stage_comm_s[k], 1))
    if not stages:
        # a whole-model placement evaluated without per-stage times: serve
        # it as one stage at the end-to-end latency
        stages.append(("compute", point.latency_s, 1))
    return stages


class VirtualBackend:
    """Stage service times straight from the operating point — the cost
    model's own numbers, so router goodput is directly gated against
    ``point.throughput_rps``."""

    def configure(self, point: PartitionConfig) -> None:
        self._times = [t for _, t, _ in stage_layout(point)]

    def stage_times(self) -> list[float]:
        return self._times


class ExecutorBackend:
    """Stage service times measured from the runtime pipeline executor.

    On :meth:`configure` the backend compiles a
    :class:`~repro_torch.runtime.pipeline.PipelineExecutor` for the operating
    point's placement, runs it ``runs`` times on a ``make_input(batch)``
    input, and serves the median measured per-stage compute times (scaled
    by ``speed_factors``, the tier emulation) with the modeled hop times.
    The executor runs on ``device`` (the card unless the caller passes
    ``device="cpu"``).
    The router's layout authority stays the operating point — the backend
    only substitutes *measured* service times for predicted ones.
    """

    def __init__(self, graph, make_input, network=None, source: str = "device",
                 speed_factors: dict[str, float] | None = None, runs: int = 3,
                 device="cuda"):
        self.graph = graph
        self.make_input = make_input
        self.network = network
        self.source = source
        self.speed_factors = speed_factors or {}
        self.runs = max(1, runs)
        self.device = device
        self._times: list[float] = []

    def configure(self, point: PartitionConfig) -> None:
        from ..runtime.pipeline import PipelineExecutor

        executor = PipelineExecutor(self.graph, point, network=self.network,
                                    source=self.source, device=self.device)
        x = self.make_input(max(1, point.batch_size))
        executor.run(x)                       # compile outside the timings
        samples: list[list] = []
        for _ in range(self.runs):
            _, timings = executor.run(x, collect_timing=True)
            samples.append(timings)
        # median per stage over the runs
        med = [sorted(s[k].compute_s for s in samples)[self.runs // 2]
               for k in range(len(samples[0]))]
        comm = [samples[0][k].comm_in_s for k in range(len(samples[0]))]
        times: list[float] = []
        layout = stage_layout(point)
        k = 0
        for kind, t, _ in layout:
            if kind == "input":
                times.append(comm[0])
            elif kind == "compute":
                sf = self.speed_factors.get(point.segments[k].resource, 1.0)
                times.append(med[k] * sf)
                k += 1
            else:                              # hop into segment k
                times.append(comm[k])
        if len(times) != len(layout):
            raise ValueError(
                f"executor produced {len(times)} stage times for a "
                f"{len(layout)}-stage operating point")
        self._times = times

    def stage_times(self) -> list[float]:
        return self._times


@dataclass
class RoutedRequest:
    """Router-side request record: one trace arrival and its outcome."""

    arrival: Arrival
    admitted_at: float | None = None      # first-stage service start
    first_out_s: float | None = None      # first compute stage done (TTFT)
    finished_s: float | None = None
    shed: bool = False
    shed_reason: str | None = None

    @property
    def latency_s(self) -> float | None:
        if self.finished_s is None:
            return None
        return self.finished_s - self.arrival.t

    @property
    def queue_wait_s(self) -> float | None:
        if self.admitted_at is None:
            return None
        return self.admitted_at - self.arrival.t


class Router:
    """Trace-driven request router over one frontier operating point.

    Feed arrivals in time order with :meth:`offer` (or serve a whole trace
    with :meth:`serve`), then :meth:`flush` and :meth:`report`.  Requests
    are either **completed** or **shed at admission** — the invariant
    ``arrivals == completed + shed`` holds for every run, across any
    number of live operating-point swaps.

    ``queue_limit`` bounds the first-stage queue in *batches*; arrivals
    that would deepen it past the limit are shed (``"queue-full"``).
    ``slo_s`` enables estimate-based admission control: an arrival whose
    shadow-walk completion estimate exceeds the SLO is shed (``"slo"``).
    ``max_wait_s`` bounds how long a partial batch may wait for fill
    before dispatching anyway (default: the time a full batch takes to
    accumulate at the operating point's own service rate).
    """

    def __init__(self, point: PartitionConfig, *, backend=None,
                 slo_s: float | None = None, queue_limit: int | None = 64,
                 max_wait_s: float | None = None):
        self.backend = backend if backend is not None else VirtualBackend()
        self.slo_s = slo_s
        self.queue_limit = queue_limit
        self._max_wait_override = max_wait_s
        self.clock = 0.0
        self.records: list[RoutedRequest] = []
        self.pending: list[RoutedRequest] = []     # forming batch (< width)
        self.swaps: list[tuple[float, float]] = []  # (asked_at, drained_at)
        self.depth_samples: Counter[int] = Counter()
        self._starts: list[list[float]] = []       # per stage: start times
        self._apply_point(point)

    # -- configuration -------------------------------------------------------
    def _apply_point(self, point: PartitionConfig,
                     free_at: float = 0.0) -> None:
        self.point = point
        self.width = max(1, point.batch_size)
        self.backend.configure(point)
        layout = stage_layout(point)
        self._kinds = [k for k, _, _ in layout]
        self._first_compute = self._kinds.index("compute")
        self.free: list[list[float]] = [[free_at] * reps
                                        for _, _, reps in layout]
        self._starts = [[] for _ in layout]
        # a full batch accumulates in width * bottleneck_s at the point's
        # own sustainable rate; waiting much longer than that only adds
        # latency, so it is the default partial-batch dispatch deadline
        self.max_wait_s = self._max_wait_override if \
            self._max_wait_override is not None else \
            max(self.width * point.bottleneck_s, 1e-9)

    def set_operating_point(self, point: PartitionConfig,
                            at: float | None = None) -> float:
        """Live re-plan: drain in-flight batches, then re-admit at the new
        operating point's width/replicas.  Returns the drain-complete time
        (the new point serves nothing earlier).  Pending (not yet
        dispatched) requests survive the swap and dispatch under the new
        point; nothing in flight is dropped."""
        at = self.clock if at is None else max(at, self.clock)
        drained = max([at] + [f for row in self.free for f in row])
        self._apply_point(point, free_at=drained)
        self.swaps.append((at, drained))
        self.clock = at
        return drained

    def on_plan(self, event) -> None:
        """ElasticController listener: a re-plan swaps the router onto the
        event's config at the current virtual clock.  Wire with
        ``controller.add_listener(router.on_plan)``."""
        self.set_operating_point(event.config)

    # -- queue telemetry -----------------------------------------------------
    def _stage_depth(self, s: int, now: float) -> int:
        """Batches queued (assigned, not yet started) at stage ``s``."""
        starts = self._starts[s]
        # prune starts that are already in service/finished
        keep = [t for t in starts if t > now]
        self._starts[s] = keep
        return len(keep)

    # -- admission -----------------------------------------------------------
    def _shadow_finish(self, t: float) -> float:
        """Completion estimate for a batch dispatched at ``t``: walk the
        stages against the current server free times without committing.
        Under saturation this tracks the backlog exactly (it is the same
        arithmetic :meth:`_launch` will apply)."""
        enter = t
        for s, dt in enumerate(self.backend.stage_times()):
            enter = max(enter, min(self.free[s])) + dt
        return enter

    def offer(self, arrival: Arrival) -> RoutedRequest:
        """Process one trace arrival (arrivals must be fed in time
        order)."""
        t = arrival.t
        if t < self.clock - 1e-12:
            raise ValueError(
                f"arrivals must be offered in time order: got t={t} after "
                f"clock={self.clock}")
        self._age_out(t)
        self.clock = max(self.clock, t)
        rec = RoutedRequest(arrival)
        self.records.append(rec)
        depth = self._stage_depth(0, t)
        self.depth_samples[depth * self.width + len(self.pending)] += 1
        if self.queue_limit is not None and depth >= self.queue_limit:
            rec.shed, rec.shed_reason = True, "queue-full"
            return rec
        if self.slo_s is not None and \
                self._shadow_finish(t) - t > self.slo_s:
            rec.shed, rec.shed_reason = True, "slo"
            return rec
        self.pending.append(rec)
        while len(self.pending) >= self.width:
            batch, self.pending = (self.pending[:self.width],
                                   self.pending[self.width:])
            self._launch(batch, at=t)
        return rec

    def _age_out(self, t: float) -> None:
        """Dispatch partial batches whose oldest member has waited past
        ``max_wait_s`` by time ``t`` (they dispatch at their deadline, not
        at ``t`` — the clock advances through the deadline)."""
        while self.pending:
            deadline = self.pending[0].arrival.t + self.max_wait_s
            if deadline > t:
                break
            batch, self.pending = (self.pending[:self.width],
                                   self.pending[self.width:])
            self._launch(batch, at=deadline)

    def flush(self) -> None:
        """Dispatch any remaining partial batches (end of trace)."""
        while self.pending:
            batch, self.pending = (self.pending[:self.width],
                                   self.pending[self.width:])
            self._launch(batch, at=self.clock)

    # -- dispatch ------------------------------------------------------------
    def _launch(self, batch: list[RoutedRequest], at: float) -> None:
        times = self.backend.stage_times()
        enter = at
        for s, dt in enumerate(times):
            # least-loaded replica wins the batch (argmin of free times)
            srv = min(range(len(self.free[s])), key=self.free[s].__getitem__)
            start = max(enter, self.free[s][srv])
            self._starts[s].append(start)
            if s == 0:
                for r in batch:
                    r.admitted_at = start
            finish = start + dt
            self.free[s][srv] = finish
            if s == self._first_compute:
                for r in batch:
                    r.first_out_s = finish
            enter = finish
        for r in batch:
            r.finished_s = enter

    # -- serving -------------------------------------------------------------
    def serve(self, trace: list[Arrival]) -> PlaneReport:
        """Serve a whole trace: offer every arrival, flush, report."""
        for a in trace:
            self.offer(a)
        self.flush()
        return self.report()

    def report(self) -> PlaneReport:
        done = [r for r in self.records if r.finished_s is not None]
        shed = [r for r in self.records if r.shed]
        lats = [r.latency_s for r in done]
        ttfts = [r.first_out_s - r.arrival.t for r in done
                 if r.first_out_s is not None]
        waits = [r.queue_wait_s for r in done if r.admitted_at is not None]
        slo = self.slo_s
        good = done if slo is None else [r for r in done
                                         if r.latency_s <= slo]
        finishes = sorted(r.finished_s for r in good)
        goodput = 0.0
        if len(finishes) >= 2 and finishes[-1] > finishes[0]:
            goodput = (len(finishes) - 1) / (finishes[-1] - finishes[0])
        t_end = max([self.clock] + [r.finished_s for r in done])
        arrivals = [r.arrival for r in self.records]
        return PlaneReport(
            arrivals=len(self.records), completed=len(done), shed=len(shed),
            shed_reasons=dict(Counter(r.shed_reason for r in shed)),
            duration_s=t_end,
            offered_rps=empirical_rate(arrivals),
            goodput_rps=goodput,
            latency_p50_s=percentile(lats, 50),
            latency_p99_s=percentile(lats, 99),
            ttft_p50_s=percentile(ttfts, 50),
            ttft_p99_s=percentile(ttfts, 99),
            queue_wait_mean_s=mean(waits),
            queue_wait_p99_s=percentile(waits, 99),
            queue_depth_hist=dict(self.depth_samples),
            slo_s=slo,
            slo_violations=len(done) - len(good) if slo is not None else 0,
            swaps=len(self.swaps))
