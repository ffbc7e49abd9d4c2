"""ssd_scan's bound over its device time in the serving sub-window: the exact admissions' prefills, B and C read once a group."""

from harness import readers

LAYER = "kernels"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "ttft_p50_ms"


def read(record):
    return readers.roofline(record, "ssd_scan")
