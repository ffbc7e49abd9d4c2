"""2·N·(useful prompt tokens) over the prefill calls' CUDA-event time and the bf16 peak."""

from harness import readers

LAYER = "model step"
UNIT = "%"
SOURCE = "program_span"
MOVES = "ttft_p50_ms"


def read(record):
    return readers.mfu(record, "prefill", "useful", train=False)
