"""decode_attention's bound over its device time in the serving sub-window."""

from harness import readers

LAYER = "kernels"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "tpot_p95_ms"


def read(record):
    return readers.roofline(record, "decode_attention")
