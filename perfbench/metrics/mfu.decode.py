"""2·N·(rows decoded) over the decode calls' CUDA-event time and the bf16 peak."""

from harness import readers

LAYER = "model step"
UNIT = "%"
SOURCE = "program_span"
MOVES = "tpot_p95_ms"


def read(record):
    return readers.mfu(record, "decode", "rows", train=False)
