"""The port's CNN zoo against the JAX package's, in numbers, on the CPU.

Weights are carried from a freshly built JAX graph (read from each node's
``apply`` closure by free-variable name, ``w`` and ``b``) into the port's
graph by ``convert.zoo_params_to_torch`` and ``cnn_zoo.load_params``.
Both run in fp32 (TF32 plays no part on the CPU).  Tolerance: relative norm
error ≤ 1e-5 for every block, each fed the JAX block's input, and for
MobileNetV2's whole graph; summation order differs between XLA's and
PyTorch's CPU kernels (~1e-7 relative), while a layout or padding fault
gives errors of order 1.  The classifier block (``pred``: dense, then a
softmax over 1000 classes) is held at 1e-5 on its logits (the port's
``Dense`` module with the same weights and no activation) and at 1e-4 on its
probabilities: softmax turns the logits' absolute error into the
probabilities' relative error, and logits of magnitude ~13 summed over 4096
fp32 terms differ by up to ~1e-5 between the two libraries, depending on how
their threads split the sums (VGG16's measured 4e-6 alone and 1.2e-5 in a
loaded run).

The nets cover every layer form: VGG16 (flatten -> dense), ResNet50 (SAME
stride-2 max pool, residual add, SAME stride-2 7x7 conv), MobileNetV2
(depthwise conv, relu6, SAME stride-2 conv), InceptionV3 (VALID conv, SAME
stride-1 avg pool, concat), Xception (SAME stride-2 max pool on an even
input, depthwise) and DenseNet121 (VALID avg pool, concat); each layer form
is held alone at odd sizes in ``test_torch_zoo_layers.py``.  Also: ResNet50
through the port's ``DagPipelineExecutor`` against the JAX one, an
``AnalyticProvider`` DB for MobileNetV2 identical to JAX's and loaded in JAX
with the same 3G/4G answers, and ``ElasticController``'s plans on the same
events as JAX's.
"""

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
from repro.core.bench import BenchmarkDB as JaxBenchmarkDB
from repro.models import cnn_zoo as jzoo
from repro.runtime.elastic import ElasticController as JaxController
from repro.runtime.pipeline import DagPipelineExecutor as JaxDagExecutor

import repro_torch.core as tcore
from repro_torch.convert import zoo_params_to_torch
from repro_torch.models import cnn_zoo
from repro_torch.runtime import DagPipelineExecutor
from repro_torch.runtime.elastic import ElasticController

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))   # benchmarks/
from benchmarks import common as jcommon  # noqa: E402
from benchmarks import common_torch as tcommon  # noqa: E402

TOL = 1e-5
SOFTMAX_TOL = 1e-4
BLOCK_NETS = ["VGG16", "ResNet50", "MobileNetV2", "InceptionV3", "Xception",
              "DenseNet121"]

_JAX: dict = {}


def jax_graph(name):
    """One JAX build per net and worker."""
    if name not in _JAX:
        _JAX[name] = jzoo.build(name)
    return _JAX[name]


def jax_params(graph) -> dict:
    """``{node: {"w", "b"}}`` read from each weighted node's apply closure."""
    out = {}
    for node in graph.nodes:
        fn = node.apply
        if fn is None or fn.__closure__ is None:
            continue
        cells = dict(zip(fn.__code__.co_freevars,
                         (c.cell_contents for c in fn.__closure__)))
        if "w" in cells:
            out[node.name] = {"w": np.asarray(cells["w"]),
                              "b": np.asarray(cells["b"])}
    return out


def torch_graph(name):
    """The port's graph on the CPU holding the JAX graph's weights."""
    g = cnn_zoo.build(name, "cpu")
    cnn_zoo.load_params(g, zoo_params_to_torch(jax_params(jax_graph(name)),
                                               "cpu"))
    return g


def _image(graph, seed=0):
    shape = tuple(graph.input_spec.shape)
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)


def rel(got, want) -> float:
    got = got.detach().double().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def test_params_carry_every_weight():
    jg, tg = jax_graph("MobileNetV2"), torch_graph("MobileNetV2")
    params = jax_params(jg)
    assert set(params) == {n for n, m in tg.modules.items()
                           if hasattr(m, "weight")}
    w = params["b1_dw"]["w"]                  # depthwise HWIO (3, 3, 1, 96)
    got = tg.modules["b1_dw"].weight
    assert got.shape == (96, 1, 3, 3)
    assert np.array_equal(got.numpy(), w.transpose(3, 2, 0, 1))
    assert got.is_contiguous(memory_format=torch.channels_last)
    d = params["pred"]["w"]                   # dense (cin, cout)
    assert np.array_equal(tg.modules["pred"].weight.numpy(), d.T)


@pytest.mark.parametrize("name", BLOCK_NETS)
def test_blocks_match_jax(name):
    jg, tg = jax_graph(name), torch_graph(name)
    jblocks, tblocks = jcore.fuse_blocks(jg), tcore.fuse_blocks(tg)
    params = jax_params(jg)
    x = _image(jg)
    with torch.no_grad():
        for jb, tb in zip(jblocks, tblocks):
            want = np.asarray(jb.make_callable()(x))
            got = tb.make_callable()(torch.from_numpy(np.array(x)))
            assert got.shape == want.shape
            where = (name, tb.index, tb.name)
            if tb.name != "pred":
                assert rel(got, want) <= TOL, where
            else:                   # the classifier: logits, then softmax
                p, m = params["pred"], tg.modules["pred"]
                logits = cnn_zoo.Dense(m.weight, m.bias, act=None)(
                    torch.from_numpy(np.array(x)))
                assert rel(logits, jnp.asarray(x) @ p["w"] + p["b"]) \
                    <= TOL, where
                assert rel(got, want) <= SOFTMAX_TOL, where
            x = want


def test_mobilenetv2_whole_graph_matches_jax():
    jg, tg = jax_graph("MobileNetV2"), torch_graph("MobileNetV2")
    x = _image(jg, seed=1)
    want, got = x, torch.from_numpy(x)
    for jb, tb in zip(jcore.fuse_blocks(jg), tcore.fuse_blocks(tg)):
        want = jb.make_callable()(want)
        got = tb.make_callable()(got)
    assert got.shape == (1, 1000)
    assert rel(got, np.asarray(want)) <= TOL


def _dag_config(core, n, how):
    """``split``: device for the first three DAG blocks, cloud for the rest;
    ``interleaved``: device and cloud in turn, so that branch and skip
    edges cross resources too."""
    segs = ((core.Segment("device", 0, 2), core.Segment("cloud", 3, n - 1))
            if how == "split" else
            tuple(core.Segment(("device", "cloud")[i % 2], i, i)
                  for i in range(n)))
    return core.PartitionConfig("ResNet50", segs, 0.0, {}, 0.0, 0.0)


@pytest.mark.parametrize("how", ["split", "interleaved"])
def test_resnet50_dag_executor_matches_jax(how):
    jg, tg = jax_graph("ResNet50"), torch_graph("ResNet50")
    n = len(jcore.fuse_block_dag(jg))
    jnet = jcore.paper_network(jcore.FOUR_G)
    tnet = tcore.paper_network(tcore.FOUR_G)
    jpipe = JaxDagExecutor(jg, _dag_config(jcore, n, how), jnet)
    tpipe = DagPipelineExecutor(tg, _dag_config(tcore, n, how), tnet,
                                device="cpu")
    assert tpipe.entry_blocks == jpipe.entry_blocks
    assert tpipe.assignment == jpipe.assignment
    x = _image(jg, seed=2)
    want, jt = jpipe.run(x, collect_timing=True)
    with torch.no_grad():
        got, tt = tpipe.run(torch.from_numpy(x), collect_timing=True)
    assert rel(got, np.asarray(want)) <= TOL
    assert [(t.block, t.resource, t.comm_in_s, t.bytes_in) for t in tt] == \
        [(t.block, t.resource, t.comm_in_s, t.bytes_in) for t in jt]
    speeds = {"device": 8.0, "cloud": 1.0}
    for t in (*tt, *jt):
        t.compute_s = 1e-3                    # the same compute on both
    assert tpipe.simulated_latency(tt, speeds) == \
        jpipe.simulated_latency(jt, speeds)


def _analytic(core, common, graph, link):
    s = core.Scission(resources=common.testbed(),
                      network=core.paper_network(link),
                      source="device", provider=core.AnalyticProvider(),
                      runs=1, **({} if core is jcore else {"device": "cpu"}))
    s.benchmark(graph)
    return s


def _answers(core, s, model, db=None):
    """The top-3 partitions, and the best one off the cloud."""
    if db is not None:
        s.load(db)
    return [[(c.describe(), c.latency_s) for c in s.query(model, q).configs]
            for q in (core.Query(top_n=3),
                      core.Query(top_n=1, exclude=("cloud", "cloud_gpu")))]


def test_analytic_db_identical_and_loads_in_jax():
    jg = jax_graph("MobileNetV2")
    tg = cnn_zoo.build("MobileNetV2", "meta")
    for link in ("THREE_G", "FOUR_G"):
        js = _analytic(jcore, jcommon, jg, getattr(jcore, link))
        ts = _analytic(tcore, tcommon, tg, getattr(tcore, link))
        tjson = ts._dbs["MobileNetV2"].to_json()
        assert tjson == js._dbs["MobileNetV2"].to_json()
        tq = _answers(tcore, ts, "MobileNetV2")
        assert tq == _answers(jcore, js, "MobileNetV2",
                              JaxBenchmarkDB.from_json(tjson))


def test_elastic_plans_match_jax():
    jg = jax_graph("ResNet50")
    tg = cnn_zoo.build("ResNet50", "meta")
    plans = []
    for core, common, graph, ctl_cls in (
            (jcore, jcommon, jg, JaxController),
            (tcore, tcommon, tg, ElasticController)):
        s = _analytic(core, common, graph, core.FOUR_G)
        ctl = ctl_cls(s, "ResNet50", graph=graph)
        ctl.on_resource_lost("edge1")
        ctl.on_network_change(core.paper_network(
            core.THREE_G, edges=("edge2",), clouds=("cloud", "cloud_gpu")))
        ctl.on_resource_joined(core.Resource("edge3", "edge",
                                             core.DeviceModel(
                                                 "e3", 7.0e10, 2.5e10),
                                             speed_factor=2.0))
        plans.append([(ev.reason, ev.config.describe(), ev.latency_s)
                      for ev in ctl.history])
    assert plans[1] == plans[0]
    assert [p[0] for p in plans[1]] == ["initial", "lost:edge1",
                                        "network-change", "joined:edge3"]

