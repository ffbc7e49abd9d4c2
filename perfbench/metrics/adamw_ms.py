"""Mean CUDA-event time of apply_updates per train step."""

from harness import readers

LAYER = "trainer"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "train_tok_s"


def read(record):
    return readers.mean_event_ms(record, "apply_updates")
