"""Share of the training sub-window with no device operation running."""

from harness import readers

LAYER = "device"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "train_tok_s"


def read(record):
    return readers.idle_share(record)
