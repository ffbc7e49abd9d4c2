"""Share of the serving sub-window with no device operation running."""

from harness import readers

LAYER = "device"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "tpot_p95_ms"


def read(record):
    return readers.idle_share(record)
