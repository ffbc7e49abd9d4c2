"""Median host time of one admission (engine.admit: the batch-1 cache, the prefill, the first token's readback, the slot write)."""

from harness import program_spans

LAYER = "serving engine"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "ttft_p50_ms"


def read(record):
    return program_spans.median_host(record, "engine.admit")
