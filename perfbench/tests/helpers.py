"""Running a cell in-process on the CPU at the tiny sizes of
``conftest.TINY``, past the harness's look for a card."""

import argparse
import copy
import time

import torch
from conftest import TINY
from harness import cli, files

_WORKLOAD = files.workload


def tiny_workload(name: str, bench=None) -> dict:
    w = _WORKLOAD(name, bench or files.BENCH)
    for key, val in TINY[name][1].items():
        if isinstance(val, dict) and isinstance(w.get(key), dict):
            w[key] = {**w[key], **copy.deepcopy(val)}
        else:
            w[key] = copy.deepcopy(val)
    return w


def run_tiny(name: str, *, seed: int = 2**31 + 3, seconds: float = 1.5,
             trace: int = 0, monkeypatch=None) -> dict:
    """One run of cell ``name`` at tiny sizes on the CPU; a test plants a
    fault in the timed path through ``monkeypatch`` first."""
    monkeypatch.setattr(files, "workload",
                        lambda n, bench=files.BENCH: tiny_workload(n, bench))
    args = argparse.Namespace(workload=name, seed=seed, seconds=seconds,
                              trace=trace)
    return cli.run_cell(args, time.perf_counter(),
                        device=torch.device("cpu"),
                        overrides=TINY[name][0])
