"""Median host time of the port's decode step (its step.decode span).

Read in the profiled sub-window, so the profiler's per-operator cost is in
it: it runs above the unprofiled ticks that perfbench's pb:decode record
times outside that window."""

from harness import program_spans

LAYER = "model step"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "tpot_p95_ms"


def read(record):
    return program_spans.median_host(record, "step.decode")
