"""The port's roofline (the H100's data-sheet constants) against
hand-worked terms and the reference's table layout, and the roofline
benchmark over the dry-run's record."""

import json
import sys
from pathlib import Path

import pytest

from repro.launch import roofline as ref
from repro_torch.launch import roofline

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))   # benchmarks/

OK = {"arch": "granite-8b", "shape": "decode_32k", "mesh": "16x16",
      "status": "OK", "n_devices": 256,
      "hlo_flops_per_device": 989e9,          # 1 ms at 989 TFLOP/s
      "hlo_bytes_per_device": 6.7e9,          # 2 ms at 3.35 TB/s
      "collective_bytes_per_device": 1.5e8,   # 3 ms at 50 GB/s
      "model_flops_total": 0.5 * 989e9 * 256,
      "memory": {"argument_bytes": 60e9, "temp_bytes": 30e9,
                 "output_bytes": 0, "alias_bytes": 0}}
RECORDS = [OK, {**OK, "arch": "zamba2-2.7b", "shape": "train_4k",
                "memory": {"argument_bytes": 1e9, "temp_bytes": 2e9}},
           {"arch": "gemma-7b", "shape": "long_500k", "mesh": "16x16",
            "status": "SKIP", "reason": "full-attention arch: 512k decode "
                                        "KV is quadratic-infeasible"},
           {"arch": "xlstm-125m", "shape": "train_4k", "mesh": "16x16",
            "status": "FAIL", "error": "boom"},
           {**OK, "mesh": "2x16x16"}]


def test_constants_are_the_h100_data_sheets():
    assert roofline.PEAK_FLOPS == 989e12
    assert roofline.HBM_BW == 3.35e12
    assert roofline.LINK_BW == 50e9
    assert roofline.HBM_PER_CHIP == 80e9


def test_analyse_gives_the_hand_worked_terms():
    a = roofline.analyse(OK)
    assert a["t_compute_s"] == pytest.approx(1e-3)
    assert a["t_memory_s"] == pytest.approx(2e-3)
    assert a["t_collective_s"] == pytest.approx(3e-3)
    assert a["dominant"] == "collective"
    assert a["useful_flops_ratio"] == pytest.approx(0.5)
    # useful time 0.5 ms over the 3 ms bound
    assert a["roofline_fraction"] == pytest.approx(0.5e-3 / 3e-3)
    assert a["fits_hbm"] is False                 # 90 GB over 80 GB
    assert a["hbm_gib"] == round(90e9 / 2**30, 2)
    assert roofline.analyse(RECORDS[2]) == RECORDS[2]


def test_analyse_keeps_the_references_keys():
    assert set(roofline.analyse(OK)) == set(ref.analyse(OK))


def test_table_has_the_references_layout():
    got = roofline.table(RECORDS).splitlines()
    want = ref.table(RECORDS).splitlines()
    assert got[:2] == want[:2]                    # header and rule
    assert len(got) == len(want) == 6             # the 16x16 records only
    for g, w in zip(got[2:], want[2:]):
        assert len(g) == len(w)
        assert g[:35] == w[:35]                   # arch and shape columns
    assert got[4] == want[4]                      # SKIP row
    assert got[5] == want[5]                      # FAIL row
    assert roofline.table(RECORDS, "2x16x16").count("\n") == 2


def test_main_reads_a_record_file(tmp_path, capsys):
    path = tmp_path / "dryrun_torch.json"
    path.write_text(json.dumps(RECORDS))
    out = tmp_path / "analysed.json"
    roofline.main(["--in", str(path), "--json-out", str(out)])
    assert "granite-8b" in capsys.readouterr().out
    assert json.loads(out.read_text())[0]["dominant"] == "collective"


def test_benchmark_without_the_record_says_how_to_make_it(tmp_path,
                                                          capsys):
    from benchmarks import bench_roofline_torch
    assert bench_roofline_torch.run(path=str(tmp_path / "missing.json")) \
        == []
    out = capsys.readouterr().out
    assert "results/dryrun_torch.json missing" in out
    assert "python -m repro_torch.launch.dryrun" in out


def test_benchmark_rows_from_a_record_file(tmp_path, capsys):
    from benchmarks import bench_roofline_torch
    path = tmp_path / "dryrun_torch.json"
    path.write_text(json.dumps(RECORDS))
    rows = bench_roofline_torch.run(path=str(path))
    assert [r[0] for r in rows] == ["roofline/granite-8b/decode_32k",
                                    "roofline/zamba2-2.7b/train_4k"]
    assert rows[0][1] == pytest.approx(3e3)       # the 3 ms bound, in us
    assert rows[0][2] == round(0.5e-3 / 3e-3, 4)
    assert "§Roofline" in capsys.readouterr().out
