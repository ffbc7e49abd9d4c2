"""What the harness imports, the work counts against hand numbers, and the
traffic's determinism."""

import ast
import json
import os
import subprocess
import sys

import pytest
import torch
from conftest import BENCH, ROOT

import traffic
from harness import work

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _tops(code: str) -> set[str]:
    """Top-level module names in sys.modules after ``code`` runs in a
    fresh interpreter with the harness and the port on the path."""
    prog = ("import sys, json\n"
            f"sys.path[:0] = [{BENCH!r}, {os.path.join(ROOT, 'src')!r}]\n"
            f"{code}\n"
            "print(json.dumps(sorted({m.split('.', 1)[0] "
            "for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                         text=True, timeout=300, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_run_loads_no_jax_and_no_jax_package():
    tops = _tops(
        "from harness import cli, files, readers, trace, weights, work\n"
        "import traffic\n"
        "from reference import lm, adamw\n"
        "for p in ('serve', 'train'): files.path_module(p)\n"
        "import glob, os\n"
        "for f in glob.glob(os.path.join(files.BENCH, 'metrics', '*.py')):\n"
        "    files.metric_module(os.path.basename(f)[:-3])\n"
        "from repro_torch.serving import ServingEngine\n"
        "from repro_torch.launch import steps\n"
        "from repro_torch.optim import init_state\n"
        "from repro_torch.models import build_model, get_config\n"
        "build_model(get_config('granite-8b'), device='meta')")
    assert "repro_torch" in tops
    assert not tops & FORBIDDEN, tops & FORBIDDEN


def test_forbidden_modules_compares_whole_top_level_names():
    from harness.cli import forbidden_modules
    assert forbidden_modules({"repro_torch.models": 1, "jaxtyping": 1}) == []
    assert forbidden_modules({"repro.kernels": 1, "jax.numpy": 1}) == \
        ["jax", "repro"]


def test_the_reference_imports_nothing_of_the_program():
    tops = _tops("from reference import lm, adamw")
    assert not tops & (FORBIDDEN | {"repro_torch"})
    for name in os.listdir(os.path.join(BENCH, "reference")):
        if not name.endswith(".py"):
            continue
        with open(os.path.join(BENCH, "reference", name)) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            for m in mods:
                assert m.split(".")[0] not in FORBIDDEN | {"repro_torch",
                                                           "harness",
                                                           "paths"}, m


def test_nothing_reads_the_old_benchmarks_folder():
    for dirpath, _, names in os.walk(BENCH):
        for name in names:
            if name.endswith(".py") and "tests" not in dirpath:
                with open(os.path.join(dirpath, name)) as f:
                    src = f.read()
                assert "benchmarks" not in src.replace("perfbench", ""), name


def test_flash_causal_work_matches_the_hand_numbers():
    # PERF.md's flash shape: (1, 4096, 32, 80) causal, q = k = v
    q = torch.empty(1, 4096, 32, 80, dtype=torch.bfloat16)
    o = torch.empty_like(q)
    flops, nbytes = work.flash_work(q, q, q, o, causal=True)
    assert round(flops / 1e9, 2) == 85.92
    assert round(nbytes / 1e6, 2) == 41.94
    # causal pairs exactly: S(S+1)/2 a head
    assert work.flash_flops(1, 5, 5, 1, 1, True) == 4 * 15
    assert work.flash_flops(1, 5, 5, 1, 1, False) == 4 * 25


def test_decode_work_reads_rows_up_to_each_length():
    q = torch.empty(2, 32, 128, dtype=torch.bfloat16)
    k = torch.empty(2, 1024, 8, 128, dtype=torch.bfloat16)
    flops, nbytes = work.decode_work(q, k, [10, 30], torch.empty_like(q))
    assert flops == 4 * 32 * 128 * 40
    assert nbytes == 2 * 40 * 8 * 128 * 2 + 2 * (2 * 32 * 128 * 2) + 4 * 2


def test_ssd_work_counts_broadcast_maps_once():
    B, S, H, P, N = 1, 256, 8, 16, 4
    x = torch.empty(B, S, H, P, dtype=torch.bfloat16)
    log_a = torch.empty(B, S, H)
    xbc = torch.empty(B, S, 2 * N, dtype=torch.bfloat16)
    b = xbc[..., :N][:, :, None].expand(B, S, H, N)
    c = xbc[..., N:][:, :, None].expand(B, S, H, N)
    y, fin = torch.empty_like(x), torch.empty(B, H, N, P)
    flops, nbytes = work.ssd_work(x, log_a, b, c, y, fin)
    assert flops == 4 * B * S * H * N * P
    assert nbytes == (2 * x.numel() * 2 + log_a.numel() * 4
                      + 2 * B * S * N * 2 + fin.numel() * 4)


def test_bound_and_peaks():
    assert work.peaks("NVIDIA H100 80GB HBM3") == (989e12, 3.35e12)
    assert work.bound_s(989e12, 0, (989e12, 3.35e12)) == 1.0
    with pytest.raises(RuntimeError):
        work.peaks("cpu")


MIX = {"arrivals": "poisson", "rate_rps": 3.0, "warmup_s": 1.0,
       "prompt_len": {"dist": "log_uniform", "lo": 32, "hi": 512},
       "new_tokens": {"dist": "log_uniform", "lo": 16, "hi": 128},
       "shape_seed": 7}


def test_traffic_is_deterministic_for_one_seed_and_differs_for_two():
    a = traffic.open_loop(MIX, 2**31 + 11, [10.0, 50.0], 49152)
    b = traffic.open_loop(MIX, 2**31 + 11, [10.0, 50.0], 49152)
    c = traffic.open_loop(MIX, 12, [10.0, 50.0], 49152)
    assert [(t, p.tolist(), n) for t, p, n in a] == \
        [(t, p.tolist(), n) for t, p, n in b]
    assert [(t, n) for t, _, n in a] != [(t, n) for t, _, n in c]
    assert [t for t, _, _ in a] == sorted(t for t, _, _ in a)
    lens = [len(p) for _, p, _ in a]
    assert min(lens) >= 32 and max(lens) <= 512
    assert all(16 <= n <= 128 for _, _, n in a)


def test_every_seed_brings_the_same_work_into_the_window():
    def window(reqs):
        return [(len(p), n) for t, p, n in reqs if t >= 10.0]

    a = traffic.open_loop(MIX, 3, [10.0, 50.0], 49152)
    c = traffic.open_loop(MIX, 2**31 + 5, [10.0, 50.0], 49152)
    assert sorted(window(a)) == sorted(window(c))
    assert window(a) != window(c)
    assert len(a) == len(c)
    assert max(t for t, _, _ in a) < 60.0


def test_percentile_is_nearest_rank():
    assert traffic.percentile([3, 1, 2, 4], 50) == 2
    assert traffic.percentile(list(range(1, 101)), 95) == 95
    assert traffic.percentile([], 95) == 0.0
