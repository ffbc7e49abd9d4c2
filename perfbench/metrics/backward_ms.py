"""Mean CUDA-event time of a train step's backward (train.backward), the remat re-runs and the plain backwards included.

The events read the stream's elapsed time while the profiler records and the
host dispatches: where the host falls behind the device, the host's pace and
the profiler's per-operator cost are in it.  Not the kernels' device time."""

from harness import program_spans

LAYER = "trainer"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "train_tok_s"


def read(record):
    return program_spans.mean_device_ms(record, "train.backward")
