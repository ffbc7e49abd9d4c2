"""6·N·tokens over the traced train steps' CUDA-event time and the bf16 peak; attention's S² term left out, so it reads low."""

from harness import readers

LAYER = "trainer"
UNIT = "%"
SOURCE = "program_span"
MOVES = "train_tok_s"


def read(record):
    return readers.mfu(record, "train_step", "tokens", train=True)
