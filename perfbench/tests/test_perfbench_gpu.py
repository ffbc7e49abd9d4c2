"""The output check's control on the card, at each cell's own size: the
reference put in the program's place and computed through float8 must
fail the check that the program passes.  The seeds are among those whose
readings ``PERF.md`` gives.  Run with

    python -m pytest -q perfbench/tests/test_perfbench_gpu.py -m gpu
"""

import json
import os
import subprocess
import sys

import pytest
from conftest import BENCH


def _card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch.cuda.is_available() is false")


def _calibrate(workload: str, seed: int, seconds: float) -> dict:
    out = subprocess.run(
        [sys.executable, os.path.join(BENCH, "calibrate.py"), "--workload",
         workload, "--seeds", str(seed), "--control-seeds", "1",
         "--seconds", str(seconds)], capture_output=True, text=True,
        timeout=900, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.gpu
def test_serve_control_fails_the_check():
    _card()
    limit = json.load(open(os.path.join(
        BENCH, "workloads", "granite-8b.chat.json")))["check"]
    line = _calibrate("granite-8b.chat", 2147485301, 30)
    assert line["program"]["max_logit_gap"] <= limit["max_logit_gap"]
    assert line["max_logit_gap"] > limit["max_logit_gap"]


@pytest.mark.gpu
def test_train_control_and_fault_fail_the_check():
    _card()
    limit = json.load(open(os.path.join(
        BENCH, "workloads", "zamba2-2.7b-simplified.train-4k.json")))["check"]
    line = _calibrate("zamba2-2.7b-simplified.train-4k", 2147485001, 2)
    assert all(line["program"][k] <= limit[k] for k in limit)
    for reading in ("control", "half_batch"):
        assert any(line[reading][k] > limit[k] for k in limit), reading
