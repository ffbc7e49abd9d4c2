"""Admission minus due time, p95 over the requests due in the window."""

from harness import readers

LAYER = "serving engine"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "ttft_p50_ms"


def read(record):
    return readers.queue_wait_p95_ms(record)
