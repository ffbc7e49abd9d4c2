#!/usr/bin/env python3
"""The rate sweep that fixes a serving cell's offered rate, on the card.

    python3 perfbench/sweep.py --workload NAME --rates 1.5,2,2.5 \
        --seeds 1,2,3 [--seconds S]

Serves the cell's traffic at each rate in turn, one run each, and prints
per rate: the arrivals due in the window, the requests completed in it,
the queue left at its close, and the end-to-end metrics.  The knee is the
highest rate at which completions keep pace with arrivals over the window;
the cell's rate is written into its file as a number, at about four fifths
of the knee.
"""

import argparse
import copy
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.join(os.path.dirname(HERE), "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--seeds", required=True, help="one seed a rate")
    args = ap.parse_args(argv)
    import torch
    from harness import cli, files

    base = files.workload(args.workload)
    rates = [float(r) for r in args.rates.split(",")]
    seeds = [int(s) for s in args.seeds.split(",")]
    if len(seeds) != len(rates):
        raise SystemExit("give one seed a rate")
    for rate, seed in zip(rates, seeds):
        cell = copy.deepcopy(base)
        cell["traffic"]["rate_rps"] = rate
        run = cli.Run(cell_name=args.workload, cell=cell,
                      config=files.config(cell["config"]), seed=seed,
                      seconds=args.seconds, trace=False,
                      device=torch.device("cuda"),
                      process_start=time.perf_counter())
        out = files.path_module("serve").run(run)
        print(json.dumps({"rate_rps": rate, "seed": seed,
                          **out["window_counts"],
                          "metrics": out["metrics"]}), flush=True)
        del out
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
