"""Package rules of the port: it stands alone, defaults to the card, and
never falls back to the CPU or counts a launch that did not happen."""

import ast
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import convert, tracing
from repro_torch.core import (Link, NetworkModel, Resource, Scission,
                              TensorSpec, TimingProvider, fuse_blocks,
                              linear_graph)
from repro_torch.core.lattice.chain import PartitionConfig, Segment
from repro_torch.core.resources import CLOUD_VM
from repro_torch.kernels import (KernelAutotuner, _build,
                                 decode_attention_node, flash_attention_node,
                                 ssd_scan_node)
from repro_torch.launch import serve, train
from repro_torch.models import DecoderLM, build_model, cnn_zoo, get_config
from repro_torch.runtime import DagPipelineExecutor, PipelineExecutor

ROOT = Path(__file__).resolve().parents[1]
SRC_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
PORT_FILES = SRC_FILES + sorted((ROOT / "benchmarks").glob("*_torch.py")) + \
    sorted((ROOT / "examples").glob("*_torch.py")) + [ROOT / "chip_smoke.py"]


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
    bad = _imported_roots(path) & {"jax", "jaxlib", "repro", "ml_dtypes",
                                   "msgpack"}
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_only_tracing_keeps_module_state_by_global_statements():
    """Counts and other bookkeeping live in :mod:`repro_torch.tracing`
    (``tracing.count``): no other module of the port rebinds a module
    global."""
    bad = [str(p.relative_to(ROOT)) for p in SRC_FILES
           if p.name != "tracing.py" and any(
               isinstance(n, ast.Global)
               for n in ast.walk(ast.parse(p.read_text())))]
    assert not bad, f"global statements in {bad}"


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_zstandard_only_guarded(path):
    """The card's host has no ``zstandard``: an import of it sits in a
    ``try`` that handles its absence."""
    tree = ast.parse(path.read_text())
    guarded = {id(n) for t in ast.walk(tree) if isinstance(t, ast.Try)
               and any(h.type is not None and "ImportError" in ast.dump(h.type)
                       for h in t.handlers)
               for stmt in t.body for n in ast.walk(stmt)}
    for node in ast.walk(tree):
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names = [a.name for a in node.names] if isinstance(
                node, ast.Import) else [node.module or ""]
            if any(n.split(".")[0] == "zstandard" for n in names):
                assert id(node) in guarded, \
                    f"{path.relative_to(ROOT)}:{node.lineno}"


def test_port_import_leaves_jax_unloaded():
    code = ("import sys, repro_torch, repro_torch.core, repro_torch.kernels,"
            " repro_torch.kernels.ops, repro_torch.kernels.ref,"
            " repro_torch.runtime, repro_torch.convert,"
            " repro_torch.kernel_graph, repro_torch.analysis.plan_lint,"
            " repro_torch.models.cnn_zoo, repro_torch.runtime.elastic,"
            " repro_torch.analysis.cost_lint, repro_torch.analysis.graph_lint,"
            " repro_torch.serving, repro_torch.serving.requests,"
            " repro_torch.serving.queues, repro_torch.serving.metrics,"
            " repro_torch.serving.sim, repro_torch.serving.router,"
            " repro_torch.runtime.ft, repro_torch.configs,"
            " repro_torch.models.layers, repro_torch.models.ssm,"
            " repro_torch.models.lm, repro_torch.models.registry,"
            " repro_torch.models.graph_adapter, repro_torch.launch.steps,"
            " repro_torch.launch.serve, repro_torch.serving.engine,"
            " repro_torch.optim, repro_torch.data, repro_torch.checkpoint,"
            " repro_torch.launch.train, repro_torch.runtime.sharding,"
            " repro_torch.kernels.sharded, repro_torch.launch.mesh,"
            " repro_torch.launch.dryrun, repro_torch.launch.roofline;"
            " bad = [m for m in sys.modules if m.split('.')[0] in"
            " ('jax', 'jaxlib', 'repro')];"
            " print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_checkpoint_imports_without_msgpack():
    """The card's host has no ``msgpack``: the port's checkpoint carries
    its own encoder and decoder."""
    code = ("import sys\n"
            "class Block:\n"
            "    def find_spec(self, name, path=None, target=None):\n"
            "        if name.split('.')[0] == 'msgpack':\n"
            "            raise ImportError('msgpack blocked')\n"
            "sys.meta_path.insert(0, Block())\n"
            "import repro_torch.checkpoint.ckpt as c\n"
            "assert c.unpackb(c.packb({'a': [1, b'x']})) == {'a': [1, b'x']}\n"
            "assert 'msgpack' not in sys.modules\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


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
    "zoo_params_to_torch": lambda **kw: convert.zoo_params_to_torch(
        {"fc": {"w": np.zeros((2, 3)), "b": np.zeros(3)}}, **kw),
    "adamw_state_to_torch": lambda **kw: convert.adamw_state_to_torch(
        {"mu": {"w": np.zeros(2)}, "nu": {"w": np.zeros(2)}, "step": 0},
        **kw),
    "cnn_zoo.build": lambda **kw: cnn_zoo.build("MobileNet", **kw),
    "DagPipelineExecutor": lambda **kw: DagPipelineExecutor(
        _graph(), _config(), **kw),
    "build_model": lambda **kw: build_model(get_config("granite-8b"), **kw),
    "DecoderLM": lambda **kw: DecoderLM(get_config("zamba2-2.7b"), **kw),
    "launch.train.main": lambda **kw: train.main(
        ["--tiny", "--steps", "1", "--batch", "2", "--seq", "8"] +
        [f"--{k}={v}" for k, v in kw.items()]),
    "launch.serve.main": lambda **kw: serve.main(
        ["--requests", "1", "--max-new", "1"] +
        [f"--{k}={v}" for k, v in kw.items()]),
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
    before = tracing.counters()
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
    assert not any((tracing.counters() - before)[f"{k}_launches"] for k in
                   ("flash_attention", "ssd_scan", "decode_attention"))
    assert _build._libs == libs
    assert all(r.vmem_limit is None and not r.pruned
               for r in tuner.records.values())


def test_build_hash_covers_sources_and_flags():
    d = _build.build_dir()
    assert d.parent == _build.BUILD_ROOT and len(d.name) == 16
    assert set(_build.SOURCES) == set(_build.SIGNATURES)
    assert all((_build.CSRC / f"{n}.cu").is_file() for n in _build.SOURCES)


@pytest.mark.parametrize("source,fn,argtypes", [
    *((n, sig[0], sig[1]) for n, sig in _build.SIGNATURES.items()),
    *((n, fn, types) for n, extra in _build.EXTRA_FUNCTIONS.items()
      for fn, types in extra.items())])
def test_c_entry_points_take_the_arguments_ctypes_passes(source, fn,
                                                         argtypes):
    """Each C function the wrappers call through ``ctypes`` is declared in
    its source with as many parameters as its ``argtypes`` lists: ctypes
    checks no count, and a missing one would read a register's garbage."""
    text = (_build.CSRC / f"{source}.cu").read_text()
    m = re.search(rf'extern "C" int {fn}\(([^)]*)\)', text)
    assert m, f"no extern \"C\" int {fn}(...) in {source}.cu"
    assert len(m.group(1).split(",")) == len(argtypes)


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
    hits = [p.relative_to(ROOT) for p in SRC_FILES
            if needle in p.read_text()]
    assert not hits, f"{needle} in {hits}"
