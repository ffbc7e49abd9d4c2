"""The port's ``scission-lint`` CLI (``python -m repro_torch.analysis``)
against the reference's on the CPU, and the port's diagnostic vocabulary.

On the example cost and plan files both CLIs give the same exit codes and
the same (code, subject) sets, with and without ``--strict`` and
``--allow``.  The kernel, tiling and graph targets are strict-clean at the
paths' shapes with the H100's limit (``--device cpu``); without a card and
without ``--device cpu`` the CLI raises, as every port entry point does.
"""

import re
from pathlib import Path

import pytest
import torch

from repro.analysis.cli import main as jmain

import repro_torch.analysis as tanalysis
from repro_torch.analysis.cli import main as tmain
from repro_torch.analysis.diagnostics import CODES
from repro_torch.analysis.kernel_smem import H100_SMEM_PER_BLOCK

ROOT = Path(__file__).resolve().parents[1]
DB = str(ROOT / "examples/dbs/edge_cloud_db.json")
BAD_DB = str(ROOT / "examples/dbs/corrupted_db.json")
PLAN = str(ROOT / "examples/plans/edge_cloud_feasible.json")
BAD_PLAN = str(ROOT / "examples/plans/edge_cloud_infeasible.json")
_DIAG = re.compile(r"^  (SCN\d{3}) (error|warning|info)(?: \[([^\]]*)\])?:",
                   re.M)


def _run(main, argv, capsys):
    rc = main(argv)
    out = capsys.readouterr().out
    return rc, {(m.group(1), m.group(3) or "") for m in _DIAG.finditer(out)}


@pytest.mark.parametrize("argv", [
    ["cost", DB],
    ["--strict", "cost", DB],
    ["cost", BAD_DB],
    ["--strict", "cost", BAD_DB],
    ["--strict", "--allow", "SCN401", "--allow", "SCN402", "--allow",
     "SCN403", "cost", BAD_DB],
    ["--strict", "--allow", "SCN402", "--allow", "SCN403", "cost", BAD_DB],
    ["--strict", "cost", PLAN, BAD_PLAN],
    [PLAN],
    ["--strict", PLAN, BAD_PLAN],
    ["--strict", "--allow", "SCN101", "--allow", "SCN103", "--allow",
     "SCN105", BAD_PLAN, "cost", DB],
])
def test_cost_and_plan_targets_match_the_reference(argv, capsys):
    want = _run(jmain, argv, capsys)
    got = _run(tmain, ["--device", "cpu", *argv], capsys)
    assert got == want
    assert want[1] or "--allow" not in argv


@pytest.mark.parametrize("target", ["kernels", "tiling", "graphs"])
def test_targets_are_strict_clean_on_the_cpu(target, capsys):
    argv = ["--device", "cpu", "--strict", "--allow", "SCN309", "--allow",
            "SCN310", target]
    assert tmain(argv) == 0
    out = capsys.readouterr().out
    if target == "kernels":
        assert f"(limit {H100_SMEM_PER_BLOCK} B)" in out
        # gemma2-9b's head_dim 256 prunes flash's 128 x 128
        assert "flash_attention at gemma2-9b prefill (1, 4096, 16, 256): " \
               "2 kept / 7 pruned of 9 candidates" in out
    if target == "tiling":
        # the xLSTM's 384-wide heads take the wide route: chunk 256 refused
        assert "ssd_scan at xlstm-125m mLSTM (1, 2048, 4, 384): 3 aligned " \
               "/ 1 flagged" in out
    if target == "graphs":
        assert "SCN309" in out and "crossed-skips" in out


def test_smem_flag_overrides_the_limit(capsys):
    assert tmain(["--device", "meta", "--smem", "100000", "kernels"]) == 0
    out = capsys.readouterr().out
    assert "(limit 100000 B)" in out
    assert "flash_attention at zamba2-2.7b prefill (1, 4096, 32, 80): 3 " \
           "kept / 6 pruned" in out
    # a limit no candidate fits: SCN202 errors fail --strict
    assert tmain(["--device", "cpu", "--smem", "1000", "--strict",
                  "kernels"]) == 1
    assert "SCN202 error" in capsys.readouterr().out


def test_ssd_wide_footprint_fits_the_limit_to_the_byte(capsys):
    """The mLSTM's wide passes take 216,064 B of shared memory at every
    chunk: a limit one byte smaller prunes all four candidates, that limit
    keeps them."""
    assert tmain(["--device", "meta", "--smem", "216063", "kernels"]) == 0
    assert "ssd_scan at xlstm-125m mLSTM (1, 2048, 4, 384): 0 kept / 4 " \
           "pruned" in capsys.readouterr().out
    assert tmain(["--device", "meta", "--smem", "216064", "kernels"]) == 0
    assert "ssd_scan at xlstm-125m mLSTM (1, 2048, 4, 384): 4 kept / 0 " \
           "pruned" in capsys.readouterr().out


def test_cost_keyword_requires_a_path():
    with pytest.raises(SystemExit):
        tmain(["--device", "cpu", "cost"])


def test_no_card_and_no_device_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmain(["cost", DB])


def test_all_emitted_codes_are_documented():
    assert all(len(c) == 6 and c.startswith("SCN") for c in CODES)
    assert {c[3] for c in CODES} == {"1", "2", "3", "4", "5"}
    src = Path(tanalysis.__file__).parent
    emitted = {c for path in src.glob("*.py")
               if path.name != "diagnostics.py"
               for c in re.findall(r'"(SCN\d{3})"', path.read_text())}
    assert emitted and emitted <= set(CODES)
    for family in ("SCN20", "SCN50"):
        assert {c for c in CODES if c.startswith(family)} <= emitted
    # the port's texts speak of the card, not the TPU
    for code in ("SCN201", "SCN202", "SCN203", "SCN204", "SCN207",
                 "SCN501", "SCN503"):
        assert not re.search(r"TPU|VMEM|jaxpr|jittable|lane", CODES[code])
