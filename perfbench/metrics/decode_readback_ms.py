"""Median host time of the engine's copy of each decode step's tokens to the host (engine.readback): its wait on the device."""

from harness import program_spans

LAYER = "serving engine"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "tpot_p95_ms"


def read(record):
    return program_spans.median_host(record, "engine.readback")
