"""Median host time of one decode_attention call (kernel.decode_attention: the wrapper's checks, planning and launch)."""

from harness import program_spans

LAYER = "kernels"
UNIT = "us"
SOURCE = "program_span"
MOVES = "tpot_p95_ms"


def read(record):
    return program_spans.median_host(record, "kernel.decode_attention",
                                     unit=1e6)
