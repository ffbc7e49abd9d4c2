"""What the per-layer metrics' readers share: each metric file under
``perfbench/metrics/`` is one call of these over the traced run's record.

A reader that finds nothing to read returns None, and the metric is left
out of the result: no share of a roofline or a peak is ever reported as 0
for want of data.
"""

from __future__ import annotations

import traffic
from harness.work import bound_s, model_flops


def _in_window(rec: dict, record: dict) -> bool:
    t_open, t_close = record["window"]
    return rec["t0"] >= t_open and rec["t1"] <= t_close


def roofline(record: dict, layer: str) -> float | None:
    """Percent of the roofline bound the layer's calls reach in the
    profiled sub-window: the sum of their bounds over the sum of the
    device time launched inside their ranges."""
    if record["peak"] is None:
        return None
    calls = [c for c in record["calls"].get(layer, ())
             if c.get("device_s")]
    if not calls:
        return None
    bound = sum(bound_s(c["flops"], c["bytes"], record["peak"])
                for c in calls)
    return 100.0 * bound / sum(c["device_s"] for c in calls)


def mfu(record: dict, step: str, count: str, train: bool) -> float | None:
    """Percent of the card's bf16 peak: model FLOPs (2·N or 6·N a useful
    token, ``count`` of each call) over the CUDA-event time of the step's
    calls in the window, leaving out those the profiler slowed."""
    if record["peak"] is None:
        return None
    calls = [c for c in record["calls"].get(step, ())
             if "event_s" in c and not c["profiled"]
             and _in_window(c, record)]
    seconds = sum(c["event_s"] for c in calls)
    if not calls or seconds <= 0:
        return None
    flops = model_flops(record["n_params"], sum(c[count] for c in calls),
                        train)
    return 100.0 * flops / (seconds * record["peak"][0])


def idle_share(record: dict) -> float | None:
    """Percent of the profiled sub-window in which no device operation
    ran."""
    tr = record.get("trace")
    if not tr or tr["window_s"] <= 0 or tr["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])


def queue_wait_p95_ms(record: dict) -> float | None:
    """p95 over the requests due in the window (before the profiler's
    sub-window) of admission minus due time; one not admitted by the close
    counts with its wait so far."""
    t_close = record["window"][1]
    waits = [((adm if adm is not None and adm <= t_close else t_close)
              - due) * 1e3 for due, adm in record["requests"]]
    return traffic.percentile(waits, 95) if waits else None


def mean_event_ms(record: dict, layer: str) -> float | None:
    """Mean CUDA-event time of the layer's calls in the window, leaving out
    those the profiler slowed (ms)."""
    calls = [c for c in record["calls"].get(layer, ())
             if "event_s" in c and not c["profiled"]
             and _in_window(c, record)]
    if not calls:
        return None
    return 1e3 * sum(c["event_s"] for c in calls) / len(calls)
