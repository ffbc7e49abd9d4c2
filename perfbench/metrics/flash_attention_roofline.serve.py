"""flash_attention's bound over its device time in the serving sub-window."""

from harness import readers

LAYER = "kernels"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "ttft_p50_ms"


def read(record):
    return readers.roofline(record, "flash_attention")
