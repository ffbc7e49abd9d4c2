"""Share of the bucketed prefills' tokens that are padding: 1 - the useful prefilled tokens (each admitted prompt but its last token) over padded_tokens (width x bucket) of the engine.admit spans, summed over the window."""

from harness import program_spans

LAYER = "serving engine"
UNIT = "%"
SOURCE = "program_span"
MOVES = "ttft_p50_ms"


def read(record):
    if record["peak"] is None:
        return None
    useful = padded = 0
    for s in program_spans.spans(record, "engine.admit"):
        a = s["attrs"]
        if a.get("padded_tokens"):
            useful += a["prompt_tokens"] - len(a["rids"])
            padded += a["padded_tokens"]
    return 100.0 * (1.0 - useful / padded) if padded else None
