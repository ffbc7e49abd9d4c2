"""Mean CUDA-event time of one SsdScan backward (kernel.ssd_scan.backward, on autograd's thread).

The events read the stream's elapsed time while the profiler records and the
host dispatches the plain backward's operators: where the host falls behind
the device, the host's pace and the profiler's per-operator cost are in it.
Not the kernels' device time."""

from harness import program_spans

LAYER = "kernels"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "train_tok_s"


def read(record):
    return program_spans.mean_device_ms(record, "kernel.ssd_scan.backward")
