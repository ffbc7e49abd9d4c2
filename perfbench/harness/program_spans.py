"""What the ``program_span`` metrics read: the spans the port's own tracer
(``repro_torch.tracing``) kept in this process.

The tracer records while a ``torch.profiler`` session records, so in a
``--trace 1`` run its spans come from the profiled sub-window; the metrics
read them after the path returns, keeping those inside the record's
window.  A reader returns None where the run had no card (no peak) and
where it finds no span, never 0; a program without the tracer has no span
to read.
"""

from __future__ import annotations

import statistics


def spans(record: dict, name: str) -> list[dict]:
    """The finished spans named ``name`` that lie inside the window."""
    try:
        from repro_torch import tracing
    except ImportError:
        return []
    t_open, t_close = record["window"]
    return [s for s in tracing.spans() if s["name"] == name
            and s["t0_ns"] / 1e9 >= t_open and s["t1_ns"] / 1e9 <= t_close]


def median_host(record: dict, name: str, unit: float = 1e3) -> float | None:
    """Median host time of the spans named ``name``, in ``unit`` per
    second (ms by default)."""
    if record["peak"] is None:
        return None
    times = [(s["t1_ns"] - s["t0_ns"]) / 1e9 * unit
             for s in spans(record, name)]
    return statistics.median(times) if times else None


def mean_device_ms(record: dict, name: str) -> float | None:
    """Mean CUDA-event time of the spans named ``name`` (ms)."""
    if record["peak"] is None:
        return None
    times = [s["device_s"] for s in spans(record, name)
             if s["device_s"] is not None]
    return 1e3 * sum(times) / len(times) if times else None
