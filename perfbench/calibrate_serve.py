#!/usr/bin/env python3
"""The output check's readings of a serving cell through its own runner.

    python3 perfbench/calibrate_serve.py --workload NAME --seeds 1,2,...
        [--control-seeds 3] [--seconds S]

As ``calibrate.py``'s serving readings, but the float8 control is read
through the cell's own runner (``perfbench/paths/<path>.py``) and its
``logit_gaps``, so that a runner with a reference of its own (as
``paths/serve_zamba2.py`` with ``reference/zamba2.py``) is held against
that reference.  One JSON line a seed: the program's ``max_logit_gap``,
the window's counts, the metrics and the memory peak, and on the first
``--control-seeds`` seeds the control's ``max_logit_gap`` over the same
sample.  The limit goes between the largest program reading and the
smallest control reading (``PERF.md`` gives both).
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.join(os.path.dirname(HERE), "src")]


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
    runner = files.path_module(cell["path"])
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        run = cli.Run(cell_name=args.workload, cell=cell,
                      config=files.config(cell["config"]), seed=seed,
                      seconds=args.seconds, trace=False, device=dev,
                      process_start=time.perf_counter())
        out = runner.run(run)
        line = {"seed": seed, "program": {k: c["value"] for k, c in
                                          out["checks"].items()},
                "shown": out.get("shown", {}),
                "counts": out.get("window_counts", {}),
                "metrics": out["metrics"],
                "memory_peak_bytes": out["memory_peak_bytes"]}
        if i < args.control_seeds:
            inp = out["reference_inputs"]
            gaps = runner.logit_gaps(inp["params"], inp["sizes"],
                                     inp["sample"], dev, fp8=True)
            line["max_logit_gap"] = max(float(g.max()) for g in gaps)
            del inp, gaps
        del out
        torch.cuda.empty_cache()
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
