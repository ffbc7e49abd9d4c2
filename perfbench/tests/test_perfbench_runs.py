"""Whole runs of each cell on the CPU at tiny sizes, past the harness's
look for a card: sound runs, the faults the output check must catch, and
a workload and a metric dropped into a copy of the harness."""

import json
import os
import shutil
import subprocess
import sys

import pytest
from conftest import BENCH, ROOT
from helpers import run_tiny

SERVE, TRAIN = "granite-8b.chat", "zamba2-2.7b-simplified.train-4k"


def test_serve_run_reports_every_end_to_end_metric(monkeypatch):
    r = run_tiny(SERVE, monkeypatch=monkeypatch)
    assert set(r["metrics"]) == {"ttft_p50_ms", "tpot_p95_ms", "out_tok_s",
                                 "setup_s"}
    assert set(r["shown"]) == {"ttft_p50_ms", "ttft_p95_ms", "tpot_p50_ms",
                               "tpot_p95_ms"}
    assert all(m["value"] > 0 for m in r["metrics"].values())
    assert r["attempted"] > 0 and r["failed"] == 0
    gap = r["checks"]["max_logit_gap"]
    assert gap["served_tokens"] >= 40 and gap["value"] == 0.0
    assert r["correct"] is True
    assert list(r)[-2:] == ["checks", "shown"]


def test_serve_traced_run_leaves_device_metrics_out_off_the_card(monkeypatch):
    r = run_tiny(SERVE, trace=1, monkeypatch=monkeypatch)
    # counted on the host: present; rooflines, mfu, idle: no device, none
    assert set(r["metrics"]) == {"queue_wait_p95_ms"}
    assert r["metrics"]["queue_wait_p95_ms"]["value"] >= 0


def _altered_decode_step(make):
    """The port's decode step with every token it produces altered."""
    def build(model):
        step = make(model)

        def altered(*args):
            nxt, logits, cache = step(*args)
            return (nxt + 1) % model.cfg.vocab, logits, cache

        return altered

    return build


def test_serve_check_catches_an_altered_token(monkeypatch):
    from repro_torch.serving import engine
    monkeypatch.setattr(engine, "make_decode_step",
                        _altered_decode_step(engine.make_decode_step))
    r = run_tiny(SERVE, monkeypatch=monkeypatch)
    gap = r["checks"]["max_logit_gap"]
    assert gap["value"] > gap["limit"]
    assert r["correct"] is False


@pytest.fixture(scope="module")
def train_sound():
    mp = pytest.MonkeyPatch()
    try:
        yield run_tiny(TRAIN, monkeypatch=mp)
    finally:
        mp.undo()


def test_train_run_reports_tokens_per_second(train_sound):
    r = train_sound
    assert set(r["metrics"]) == {"train_tok_s", "setup_s"}
    assert r["metrics"]["train_tok_s"]["value"] > 0
    assert set(r["checks"]) == {"grad_diff", "grad_gap", "change_gap"}
    assert set(r["shown"]) == {"grad_diff_widest_leaf",
                               "grad_gap_widest_leaf", "loss_gap"}
    assert r["correct"] is True


def _plant(fault: str, monkeypatch) -> None:
    """A fault in the port's train step: its updates dropped, so the
    state comes back unchanged; or the second half of each batch's labels
    left out, the mean taken over the rest."""
    from repro_torch.launch import steps
    if fault == "unchanged":
        monkeypatch.setattr(steps, "apply_updates",
                            lambda cfg, p, g, s: (p, s, {}))
        return
    make = steps.make_train_step

    def build(*args, **kwargs):
        step = make(*args, **kwargs)

        def halved(params, opt, batch):
            labels = batch["labels"].clone()
            labels[:, labels.shape[1] // 2:] = -1
            return step(params, opt, {**batch, "labels": labels})

        return halved

    monkeypatch.setattr(steps, "make_train_step", build)


@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
def test_train_check_catches_a_fault(fault, train_sound, monkeypatch):
    _plant(fault, monkeypatch)
    r = run_tiny(TRAIN, monkeypatch=monkeypatch)
    assert r["correct"] is False
    assert r["checks"]["grad_gap"]["value"] > \
        train_sound["checks"]["grad_gap"]["value"]


def test_a_dropped_in_workload_and_metric_are_found_by_name(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((open(os.path.join(ROOT, "BENCHMARK.json"))).read())
    new = "granite-8b.chat-copy"
    cell = json.load(open(os.path.join(BENCH, "workloads",
                                       f"{SERVE}.json")))
    (root / "perfbench" / "workloads" / f"{new}.json").write_text(
        json.dumps(cell))
    (root / "perfbench" / "metrics" / "dropped_metric.py").write_text(
        '"""A reader added as a file."""\n\n\n'
        "def read(record):\n"
        '    return float(len(record["calls"]["prefill"]))\n')
    bench["workloads"].append({"name": new, "config": "granite-8b",
                               "traffic": "chat-copy", "chips": 1,
                               "why": "a copy"})
    for m in bench["end_to_end"]:
        if "workloads" in m and SERVE in m["workloads"]:
            m["workloads"].append(new)
    bench["per_layer"].append({"name": "dropped_metric", "unit": "calls",
                               "better": "lower", "source": "program_span",
                               "layer": "serving engine",
                               "moves": "ttft_p95_ms", "workloads": [new]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    prog = (
        "import sys, json, pytest\n"
        f"sys.path[:0] = [{str(root / 'perfbench' / 'tests')!r}, "
        f"{str(root / 'perfbench')!r}, {os.path.join(ROOT, 'src')!r}]\n"
        "import conftest, helpers\n"
        f"conftest.TINY[{new!r}] = conftest.TINY[{SERVE!r}]\n"
        "mp = pytest.MonkeyPatch()\n"
        f"r = helpers.run_tiny({new!r}, trace=1, monkeypatch=mp)\n"
        "print(json.dumps(r['metrics']))\n")
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                         text=True, timeout=600, cwd=root)
    assert out.returncode == 0, out.stderr[-3000:]
    metrics = json.loads(out.stdout.strip().splitlines()[-1])
    assert metrics == {"dropped_metric": {"value": metrics["dropped_metric"]
                                          ["value"], "unit": "calls"}}
    assert metrics["dropped_metric"]["value"] > 0


def test_a_checkout_without_the_program_prints_no_result(tmp_path):
    shutil.copytree(BENCH, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", SERVE, "--seed",
         "1", "--seconds", "1", "--trace", "0"], capture_output=True,
        text=True, timeout=300, cwd=tmp_path)
    assert out.returncode != 0
    assert '"correct"' not in out.stdout
