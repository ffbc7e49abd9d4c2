#!/usr/bin/env python3
"""Readings that the output check's limits are set from, on the card.

    python3 perfbench/calibrate.py --workload NAME --seeds 1,2,...
        [--control-seeds 3] [--seconds S]

For each seed, one run of the cell's timed path at the cell's own load
(``--seconds`` long, the program's readings), and on the first
``--control-seeds`` seeds the control: the reference put in the program's
place and computed through float8, the precision below the bf16 the
configurations state (``reference/lm.py``).  A training cell also reads
the planted fault of half the batch's labels left out, in the reference,
and shows each training reading's widest leaves beside the numbers.
One JSON line a seed; the limit goes between the largest sound reading
and the smallest control or fault reading (``PERF.md`` gives both).
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.join(os.path.dirname(HERE), "src")]


def serve_control(out, device) -> dict:
    from paths.serve import logit_gaps
    inp = out["reference_inputs"]
    gaps = logit_gaps(inp["params"], inp["sizes"], inp["sample"], device,
                      fp8=True)
    return {"max_logit_gap": max(float(g.max()) for g in gaps)}


def train_control(out, run) -> dict:
    """The float8 control and half the batch's labels left out, each in
    the reference, read against the fp32 reference as the program is."""
    from harness import model as port
    from paths import train
    model, _ = port.build(run)
    t = run.cell["train"]
    want = out["readings"]["reference"]
    first = train.reference_readings(
        model.spec(), port.sizes(run), {**t, "checked": 1}, run.seed,
        t["batch"], t["seq"], run.device, keep=True)["grads"]
    got = {}
    for name, kw in (("control", {"fp8": True}),
                     ("half_batch", {"half": True})):
        read = train.reference_readings(
            model.spec(), port.sizes(run), t, run.seed, t["batch"],
            t["seq"], run.device, against=first, **kw)
        numbers, shown = train.compare(read, want, read["diff"])
        got[name] = {**numbers, **shown}
    return got


def widest_leaves(readings, n: int = 5) -> list:
    """The program's ``n`` leaves of the widest first-gradient difference:
    name, that difference and the gap of norms, each over the larger of
    the leaf's and the median leaf's reference norm, and the leaf's
    reference norm."""
    from paths import train
    want = readings["reference"]
    rel = train.leaf_diffs(want["diff"], want["grad"])
    gap = train.leaf_gaps(readings["program"]["grad"], want["grad"])
    rows = sorted(zip(rel, gap, want["grad"], want["names"]), reverse=True)
    return [[name, d, g, w] for d, g, w, name in rows[:n]]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=20.0)
    args = ap.parse_args(argv)
    import torch
    from harness import cli, files

    dev = torch.device("cuda")
    cell = files.workload(args.workload)
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        run = cli.Run(cell_name=args.workload, cell=cell,
                      config=files.config(cell["config"]), seed=seed,
                      seconds=args.seconds, trace=False, device=dev,
                      process_start=time.perf_counter())
        out = files.path_module(cell["path"]).run(run)
        line = {"seed": seed, "program": {k: c["value"] for k, c in
                                          out["checks"].items()},
                "shown": out.get("shown", {}),
                "counts": out.get("window_counts", {}),
                "metrics": out["metrics"],
                "memory_peak_bytes": out["memory_peak_bytes"]}
        if cell["path"] == "train":
            line["widest_leaves"] = widest_leaves(out["readings"])
        if i < args.control_seeds:
            line.update(serve_control(out, dev) if cell["path"] == "serve"
                        else train_control(out, run))
        del out
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
