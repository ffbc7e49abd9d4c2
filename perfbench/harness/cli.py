"""The command line of one run: parse, find the cell's files, check the
card, drive the path, read the per-layer metrics, print the result.

The result is the last line of standard output, one JSON object::

    {"correct": ..., "attempted": ..., "failed": ..., "metrics": {...},
     "device": {...}, ["breakdown": {...},] "checks": {...}}

``checks`` comes last: each number that decides ``correct`` with its
limit.  The same numbers are the last lines of standard error.
"""

from __future__ import annotations

import argparse
import json
import sys
from dataclasses import dataclass, field
from typing import Any

from . import files

# top-level module names the run may not hold once its window has closed:
# the JAX package and JAX itself (the port's own name, repro_torch, is a
# different top-level name)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclass
class Run:
    """What a path needs to know about one run."""

    cell_name: str
    cell: dict
    config: dict
    seed: int
    seconds: float
    trace: bool
    device: Any                      # torch.device
    process_start: float             # time.perf_counter() at process start
    # for tests of the harness itself: sizes that replace the config's
    overrides: dict = field(default_factory=dict)


def forbidden_modules(modules=None) -> list[str]:
    """Top-level names in ``sys.modules`` (by the part before the first
    dot, compared whole) that are JAX or the JAX package."""
    modules = sys.modules if modules is None else modules
    tops = {name.split(".", 1)[0] for name in list(modules)}
    return sorted(tops & set(FORBIDDEN))


def parse(argv) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="perfbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def fail(msg: str) -> int:
    print(f"perfbench: {msg}", file=sys.stderr, flush=True)
    return 2


def card_count(chips: int) -> str | None:
    """Why the card cannot run a cell of ``chips`` chips, or None."""
    import torch
    if not torch.cuda.is_available():
        return "torch.cuda.is_available() is false: no card, no result"
    if torch.cuda.device_count() < chips:
        return (f"the cell asks for {chips} cards, "
                f"torch.cuda.device_count() is {torch.cuda.device_count()}")
    return None


def power_limit() -> str | None:
    """``nvidia-smi``'s power limit of card 0, or None."""
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def per_layer_values(entries: list, record: dict) -> dict:
    """Each per-layer metric's reader over the traced run's record; a
    reader that finds nothing to read returns None and the metric is left
    out."""
    out = {}
    for m in entries:
        value = files.metric_module(m["name"]).read(record)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def run_cell(args, process_start: float, *, device=None, overrides=None,
             bench_json=None) -> dict:
    """Drive one cell; returns the result object (not yet printed).  A test
    passes ``device`` (the CPU) to skip the look for a card."""
    import torch

    bench_json = bench_json if bench_json is not None else files.benchmark()
    cells = {w["name"]: w for w in bench_json["workloads"]}
    if args.workload not in cells:
        raise KeyError(f"no workload {args.workload!r} in BENCHMARK.json")
    cell = files.workload(args.workload)
    entry = cells[args.workload]
    if cell["config"] != entry["config"]:
        raise ValueError(f"{args.workload}: BENCHMARK.json names config "
                         f"{entry['config']!r}, the workload's file "
                         f"{cell['config']!r}")
    if device is None:
        why = card_count(entry["chips"])
        if why:
            raise SystemExit(fail(why))
        device = torch.device("cuda", 0)
    run = Run(cell_name=args.workload, cell=cell,
              config=files.config(cell["config"]), seed=args.seed,
              seconds=args.seconds, trace=bool(args.trace), device=device,
              process_start=process_start, overrides=overrides or {})
    e2e, per_layer = files.cell_metrics(bench_json, args.workload)
    out = files.path_module(cell["path"]).run(run)

    found = forbidden_modules()
    if found:
        raise SystemExit(fail(f"the run holds {', '.join(found)} in "
                              "sys.modules once its window closed"))
    if args.trace:
        metrics = per_layer_values(per_layer, out["record"])
    else:
        metrics = {}
        for m in e2e:
            if m["name"] not in out["metrics"]:
                raise KeyError(f"{cell['path']} path reports no "
                               f"{m['name']!r}")
            metrics[m["name"]] = {"value": out["metrics"][m["name"]],
                                  "unit": m["unit"]}
    checks = out["checks"]
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else str(device)),
           "count": entry["chips"],
           "memory_peak_bytes": out["memory_peak_bytes"]}
    result = {"correct": correct, "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics, "device": dev}
    if args.trace and out.get("trace"):
        dev["busy_s"] = out["trace"]["busy_s"]
        dev["window_s"] = out["trace"]["window_s"]
        result["breakdown"] = out["trace"]["breakdown"]
    if device.type == "cuda":
        result["power_limit"] = power_limit()
    result["checks"] = checks
    if out.get("shown"):
        result["shown"] = out["shown"]
    return result


def main(argv, process_start: float) -> int:
    args = parse(argv)
    try:
        result = run_cell(args, process_start)
    except SystemExit as e:
        return int(e.code or 2)
    for name, value in result.pop("shown", {}).items():
        print(f"reading {name}: {value!r} (not compared)", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


