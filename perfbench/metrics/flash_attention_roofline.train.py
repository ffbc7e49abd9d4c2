"""flash_attention's bound over its device time in the training sub-window, the remat re-runs included."""

from harness import readers

LAYER = "kernels"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "train_tok_s"


def read(record):
    return readers.roofline(record, "flash_attention")
