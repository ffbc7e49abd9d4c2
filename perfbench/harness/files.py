"""Finding a cell's pieces by name.

Everything that belongs to one configuration, one workload or one
per-layer metric is a file of its own, found by the name ``BENCHMARK.json``
gives it:

* ``perfbench/workloads/<cell>.json``: the configuration's name, the path
  (``serve`` or ``train``), the traffic parameters, the limits of the
  output check, and ``why``;
* ``perfbench/configs/<config>.json``: the sizes as they are run;
* ``perfbench/paths/<path>.py``: the runner of one entry point;
* ``perfbench/metrics/<metric>.py``: one per-layer metric's reader.

A later change adds a cell, a configuration or a metric by adding files
and entries; no file here names one.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]     # perfbench/
ROOT = BENCH.parent


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    """``BENCHMARK.json`` at the checkout's root."""
    return _json(root / "BENCHMARK.json")


def workload(name: str, bench: Path = BENCH) -> dict:
    return _json(bench / "workloads" / f"{name}.json")


def config(name: str, bench: Path = BENCH) -> dict:
    return _json(bench / "configs" / f"{name}.json")


def _module(path: Path, name: str):
    if not path.is_file():
        raise FileNotFoundError(f"no file {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def path_module(kind: str, bench: Path = BENCH):
    """The runner ``perfbench/paths/<kind>.py``."""
    return _module(bench / "paths" / f"{kind}.py", f"paths.{kind}")


def metric_module(name: str, bench: Path = BENCH):
    """The reader ``perfbench/metrics/<name>.py`` (a name may hold dots)."""
    return _module(bench / "metrics" / f"{name}.py",
                   "metrics_" + name.replace(".", "_").replace("-", "_"))


def cell_metrics(bench_json: dict, cell: str) -> tuple[list, list]:
    """The end-to-end and per-layer metric entries of ``BENCHMARK.json``
    that ``cell`` reports: those that list it under ``workloads``, and
    those with no such key (a per-layer one only where the cell reports
    the end-to-end metric it moves)."""
    def listed(entry):
        return "workloads" not in entry or cell in entry["workloads"]

    e2e = [m for m in bench_json["end_to_end"] if listed(m)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench_json["per_layer"] if listed(m)
                 and ("workloads" in m or m["moves"] in names)]
    return e2e, per_layer
