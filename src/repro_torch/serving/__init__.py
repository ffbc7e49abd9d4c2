"""The port's serving plane: trace-driven, frontier-placed request plane.

The JAX-free layers of the reference's ``repro.serving``, copied with only
their imports changed:

* :mod:`repro_torch.serving.requests` — request lifecycle + open-loop
  arrival traces (seeded Poisson / bursty-diurnal generators)
* :mod:`repro_torch.serving.queues` — bounded stage queues, prompt
  buckets, and the KV cache slot pool
* :mod:`repro_torch.serving.router` — trace-driven request router over a
  frontier operating point (admission control, SLO shedding, replica load
  balancing, live operating-point swaps); its ``ExecutorBackend`` drives
  the port's ``PipelineExecutor`` on an explicit ``device``
* :mod:`repro_torch.serving.metrics` — p50/p99 latency, TTFT, goodput vs
  SLO, queue-depth histograms
* :mod:`repro_torch.serving.sim` — closed-form pipeline throughput
  simulation
* :mod:`repro_torch.serving.engine` — the continuous-batching
  model-serving engine over the LM models' prefill and decode steps, which
  launch the hand-written kernels on the card

Everything the reference's package exports is exported here.
``KVCachePool``, ``Request``, ``ServingStats`` and
``simulate_pipeline_throughput``, which the reference re-exports through
its engine module, come from their own modules here.
"""

from .engine import ServingEngine
from .metrics import PlaneReport, ServingStats, mean, percentile
from .queues import PROMPT_BUCKETS, KVCachePool, StageQueue, bucket_for
from .requests import (Arrival, Request, arrivals_to_requests,
                       bursty_diurnal_trace, empirical_rate, poisson_trace)
from .router import ExecutorBackend, RoutedRequest, Router, VirtualBackend
from .sim import simulate_pipeline_throughput

__all__ = [
    "Arrival", "ExecutorBackend", "KVCachePool", "PROMPT_BUCKETS",
    "PlaneReport", "Request", "RoutedRequest", "Router", "ServingEngine",
    "ServingStats", "StageQueue", "VirtualBackend", "arrivals_to_requests", "bucket_for",
    "bursty_diurnal_trace", "empirical_rate", "mean", "percentile",
    "poisson_trace", "simulate_pipeline_throughput",
]
