"""2·(applied parameters)·(rows decoded) over the decode calls' CUDA-event time and the bf16 peak.

``mfu.decode`` counts 2·N with each parameter once; a published Zamba2
applies each shared block at each of its applications, so the runner that
serves it records ``n_applied`` and this reads that in N's place.  A record
without it reads nothing."""

from harness import readers

LAYER = "model step"
UNIT = "%"
SOURCE = "program_span"
MOVES = "tpot_p95_ms"


def read(record):
    if record.get("n_applied") is None:
        return None
    return readers.mfu({**record, "n_params": record["n_applied"]},
                       "decode", "rows", train=False)
