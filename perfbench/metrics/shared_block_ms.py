"""Mean CUDA-event ms of one application of a published Zamba2 shared block (zamba2.shared_block) in the window's prefills, per 1000 prompt tokens.

Read in the profiled sub-window: the events read the stream's elapsed time
while the profiler records, the host's pace in them where it falls behind.
Decode replays CUDA graphs and runs no span."""

from harness import program_spans

LAYER = "model step"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "ttft_p50_ms"


def read(record):
    if record["peak"] is None:
        return None
    per_k = [1e6 * s["device_s"] / s["attrs"]["tokens"]
             for s in program_spans.spans(record, "zamba2.shared_block")
             if s["device_s"] is not None and s["attrs"].get("tokens")]
    return sum(per_k) / len(per_k) if per_k else None
