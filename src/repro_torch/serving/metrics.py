"""Serving metrics: latency percentiles, TTFT, goodput vs SLO, queue depth.

One vocabulary for both halves of the request plane: the real
:class:`~repro.serving.engine.ServingEngine` reports a
:class:`ServingStats` per run (now including queue-wait percentiles), and
the trace-driven :class:`~repro_torch.serving.router.Router` reports a
:class:`PlaneReport` per served trace.  Percentiles use the nearest-rank
method (``percentile``) so every reported number is an actually-observed
sample, not an interpolation artifact — p99 of 10 samples is the worst
sample, not a blend.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field


def percentile(xs, p: float) -> float:
    """Nearest-rank percentile: the smallest observed value >= ``p``\\ % of
    the sample (0.0 for an empty sample).  ``percentile(xs, 50)`` of an
    odd-length sample is its median element; ``percentile(xs, 100)`` is
    the maximum."""
    if not 0 < p <= 100:
        raise ValueError(f"percentile must be in (0, 100], got {p}")
    xs = sorted(xs)
    if not xs:
        return 0.0
    # nearest-rank: ceil(p/100 * n), 1-indexed; the epsilon keeps exact
    # ranks (p=50 of n=4 -> rank 2) from spilling over via float error
    rank = max(1, math.ceil(p * len(xs) / 100.0 - 1e-9))
    return xs[min(rank, len(xs)) - 1]


def mean(xs) -> float:
    xs = list(xs)
    return sum(xs) / len(xs) if xs else 0.0


@dataclass
class ServingStats:
    """Measured throughput of one :meth:`ServingEngine.run` — the observed
    counterpart of :attr:`PartitionConfig.throughput_rps`.

    ``wall_s`` is the wall-clock of the run itself, so on an **un-warmed**
    engine the first run still includes jit compilation of the
    prefill/decode steps; call :meth:`ServingEngine.warmup` first (or do a
    throwaway run) before comparing against predictions.  Queue wait is
    measured per request from submission to cache-slot admission;
    ``queue_wait_mean_s`` / ``queue_wait_p99_s`` summarize the finished
    requests of the run.
    """

    requests: int = 0
    tokens: int = 0
    wall_s: float = 0.0
    queue_wait_mean_s: float = 0.0
    queue_wait_p99_s: float = 0.0

    @property
    def requests_per_s(self) -> float:
        return self.requests / self.wall_s if self.wall_s > 0 else 0.0

    @property
    def tokens_per_s(self) -> float:
        return self.tokens / self.wall_s if self.wall_s > 0 else 0.0


@dataclass
class PlaneReport:
    """Summary of one served trace (router request plane).

    ``goodput_rps`` counts only completions within the SLO (all
    completions when no SLO is set), measured over the steady-state span
    between the first and last good completion.  ``offered_rps`` is the
    trace's empirical arrival rate; the admission-control story of a run
    is ``arrivals == completed + shed`` (nothing is silently lost).
    ``queue_depth_hist`` maps observed admission-queue depth -> count,
    sampled at every arrival.
    """

    arrivals: int = 0
    completed: int = 0
    shed: int = 0
    shed_reasons: dict[str, int] = field(default_factory=dict)
    duration_s: float = 0.0
    offered_rps: float = 0.0
    goodput_rps: float = 0.0
    latency_p50_s: float = 0.0
    latency_p99_s: float = 0.0
    ttft_p50_s: float = 0.0
    ttft_p99_s: float = 0.0
    queue_wait_mean_s: float = 0.0
    queue_wait_p99_s: float = 0.0
    queue_depth_hist: dict[int, int] = field(default_factory=dict)
    slo_s: float | None = None
    slo_violations: int = 0
    swaps: int = 0

    @property
    def completed_rps(self) -> float:
        return self.completed / self.duration_s if self.duration_s > 0 \
            else 0.0

    def as_dict(self) -> dict:
        """JSON-ready view (benchmark artifacts)."""
        return {
            "arrivals": self.arrivals, "completed": self.completed,
            "shed": self.shed, "shed_reasons": dict(self.shed_reasons),
            "duration_s": round(self.duration_s, 6),
            "offered_rps": round(self.offered_rps, 4),
            "goodput_rps": round(self.goodput_rps, 4),
            "latency_p50_s": round(self.latency_p50_s, 6),
            "latency_p99_s": round(self.latency_p99_s, 6),
            "ttft_p50_s": round(self.ttft_p50_s, 6),
            "ttft_p99_s": round(self.ttft_p99_s, 6),
            "queue_wait_mean_s": round(self.queue_wait_mean_s, 6),
            "queue_wait_p99_s": round(self.queue_wait_p99_s, 6),
            "queue_depth_hist": {str(k): v for k, v in
                                 sorted(self.queue_depth_hist.items())},
            "slo_s": self.slo_s, "slo_violations": self.slo_violations,
            "swaps": self.swaps,
        }
