"""Package rules of the port: it stands alone, defaults to the card, and
never falls back to the CPU or counts a launch that did not happen."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.core import (Link, NetworkModel, Resource, Scission,
                              TensorSpec, TimingProvider, fuse_blocks,
                              linear_graph)
from repro_torch.core.lattice.chain import PartitionConfig, Segment
from repro_torch.core.resources import CLOUD_VM
from repro_torch.kernels import (KernelAutotuner, _build,
                                 decode_attention_node, flash_attention_node,
                                 ssd_scan_node)
from repro_torch.kernels import decode_attention as da_mod
from repro_torch.kernels import flash_attention as fa_mod
from repro_torch.kernels import ssd_scan as ssd_mod
from repro_torch.runtime import PipelineExecutor

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]


def _imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax_and_no_reference(path):
    bad = _imported_roots(path) & {"jax", "jaxlib", "repro", "ml_dtypes"}
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_port_import_leaves_jax_unloaded():
    code = ("import sys, repro_torch, repro_torch.core, repro_torch.kernels,"
            " repro_torch.kernels.ops, repro_torch.kernels.ref,"
            " repro_torch.runtime, repro_torch.convert,"
            " repro_torch.kernel_graph, repro_torch.analysis.plan_lint,"
            " repro_torch.analysis.cost_lint, repro_torch.analysis.graph_lint;"
            " bad = [m for m in sys.modules if m.split('.')[0] in"
            " ('jax', 'jaxlib', 'repro')];"
            " print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _graph():
    return linear_graph("toy", TensorSpec((1, 32, 2, 16), torch.float32),
                        [flash_attention_node("attn", device="cpu"),
                         ssd_scan_node("ssd", state_dim=8, device="cpu")])


def _config():
    return PartitionConfig("toy", (Segment("cloud", 0, 1),), 0.0, {}, 0.0,
                           0.0)


_ENTRY_POINTS = {
    "Scission": lambda **kw: Scission(
        [Resource("cloud", "cloud", CLOUD_VM)], NetworkModel(), "cloud",
        **kw),
    "TimingProvider": lambda **kw: TimingProvider(**kw),
    "KernelAutotuner": lambda **kw: KernelAutotuner(**kw),
    "PipelineExecutor": lambda **kw: PipelineExecutor(_graph(), _config(),
                                                      **kw),
    "flash_attention_node": lambda **kw: flash_attention_node(**kw),
    "decode_attention_node": lambda **kw: decode_attention_node(
        cache_len=8, kv_heads=1, head_dim=8, **kw),
    "ssd_scan_node": lambda **kw: ssd_scan_node(**kw),
    "to_torch": lambda **kw: convert.to_torch({"w": np.zeros(2)}, **kw),
}


@pytest.mark.parametrize("name", sorted(_ENTRY_POINTS))
def test_entry_points_need_cuda_unless_cpu(no_cuda, name):
    make = _ENTRY_POINTS[name]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make()
    make(device="cpu")


def test_cpu_scission_loop_launches_no_kernel():
    """The whole loop on the CPU takes the plain versions: no launch is
    counted and no CUDA library is built or loaded."""
    fa_mod.launches = ssd_mod.launches = da_mod.launches = 0
    libs = dict(_build._libs)
    graph = _graph()
    res = [Resource("edge1", "edge", CLOUD_VM, speed_factor=2.0),
           Resource("cloud", "cloud", CLOUD_VM)]
    net = NetworkModel(default=Link("wired", 0.005, 1e8))
    tuner = KernelAutotuner(
        candidates={"flash_attention": [{"block_q": 16, "block_k": 16}],
                    "ssd_scan": [{"chunk": 16}]}, runs=1, device="cpu")
    sc = Scission(res, net, source="edge1",
                  provider=TimingProvider(tuner=tuner, device="cpu"), runs=1,
                  device="cpu")
    sc.benchmark(graph)
    best = sc.best("toy", input_bytes=4096.0)
    x = torch.randn(1, 32, 2, 16)
    y, timings = PipelineExecutor(graph, best, net, source="edge1",
                                  device="cpu").run(x, collect_timing=True)
    whole = x
    for blk in fuse_blocks(graph):
        whole = blk.make_callable()(whole)
    assert torch.equal(y, whole) and len(timings) == len(best.segments)
    assert fa_mod.launches == ssd_mod.launches == da_mod.launches == 0
    assert _build._libs == libs
    assert all(r.vmem_limit is None and not r.pruned
               for r in tuner.records.values())


def test_build_hash_covers_sources_and_flags():
    d = _build.build_dir()
    assert d.parent == _build.BUILD_ROOT and len(d.name) == 16
    assert set(_build.SOURCES) == set(_build.SIGNATURES)
    assert all((_build.CSRC / f"{n}.cu").is_file() for n in _build.SOURCES)


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_cuda(tmp_path, where):
    """Without a card (hidden here even on a GPU host), or without the rest
    of the repo, the smoke script exits non-zero and prints no result
    line."""
    script = ROOT / "chip_smoke.py"
    if where == "alone":
        (tmp_path / "chip_smoke.py").write_text(script.read_text())
        script = tmp_path / "chip_smoke.py"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    proc = subprocess.run([sys.executable, str(script)], cwd=script.parent,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


@pytest.mark.parametrize("needle", ["scaled_dot_product_attention",
                                    "torch.compile", "cudnn"])
def test_port_calls_no_library_attention(needle):
    """The kernels' work is the port's own: no fused library attention and
    no compiled plain version (chip_smoke.py times SDPA as a yardstick)."""
    hits = [p.relative_to(ROOT) for p in PORT_FILES[:-1]
            if needle in p.read_text()]
    assert not hits, f"{needle} in {hits}"
