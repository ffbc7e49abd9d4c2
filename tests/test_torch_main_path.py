"""The port's Scission loop against the JAX package's, on the CPU.

Both packages build the kernel-bearing graph of benchmarks/bench_autotune.py
(attention -> dense -> SSD -> dense) at (1, 96, 2, 32) fp32 with SSM state
16, with the same numpy weights (carried into the port by
``repro_torch.convert``).  Checked: identical partition points, blocks and
boundary bytes; an analytic BenchmarkDB that is byte-identical JSON and that
the JAX package loads and queries to the same result; identical autotuned
block sizes under one deterministic measurement hook; and a two-segment
pipeline run allclose to the JAX executor's at 2e-5 (fp32: the two plain
kernels agree with the Pallas kernels to ~1e-6 and tanh layers damp it).
"""

import inspect
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
from repro.core.bench import BenchmarkDB as JaxBenchmarkDB
from repro.core.resources import CLOUD_VM as J_CLOUD_VM, EDGE_BOX_1 as J_EDGE
from repro.kernels.ops import flash_attention_node as j_attn_node
from repro.kernels.ops import ssd_scan_node as j_ssd_node
from repro.kernels.substrate import KernelAutotuner as JaxAutotuner
from repro.runtime.pipeline import PipelineExecutor as JaxExecutor

import repro_torch.core as tcore
from repro_torch.convert import array_to_tensor, to_torch
from repro_torch.core.resources import CLOUD_VM, EDGE_BOX_1
from repro_torch.kernel_graph import kernel_graph
from repro_torch.kernels import KernelAutotuner
from repro_torch.runtime import PipelineExecutor

SHAPE = (1, 96, 2, 32)
STATE = 16


def _weights():
    rng = np.random.default_rng(0)
    return {n: (rng.standard_normal((32, 32)) * 0.05).astype(np.float32)
            for n in ("mlp0", "mlp1")}


def _jax_graph(w):
    def mlp(name):
        return jcore.LayerNode(name=name, kind="dense",
                               apply=lambda x, w=jnp.asarray(w[name]):
                               jnp.tanh(x @ w),
                               flops=2.0 * 32 * 32, param_bytes=4 * 32 * 32)
    return jcore.linear_graph(
        "autotune-demo", jax.ShapeDtypeStruct(SHAPE, jnp.float32),
        [j_attn_node("attn", interpret=True), mlp("mlp0"),
         j_ssd_node("ssd", state_dim=STATE, interpret=True), mlp("mlp1")])


def _torch_graph(w):
    return kernel_graph(tcore.TensorSpec(SHAPE, torch.float32),
                        to_torch(w, "cpu"), state_dim=STATE, device="cpu")


@pytest.fixture(scope="module")
def graphs():
    w = _weights()
    return _jax_graph(w), _torch_graph(w)


def _resources(core, edge, cloud):
    return [core.Resource("edge1", "edge", edge, speed_factor=2.0),
            core.Resource("cloud", "cloud", cloud, speed_factor=1.0)]


def _ranked(core, db, resources):
    net = core.NetworkModel(default=core.Link("wired", 0.005, 1e8))
    engine = core.QueryEngine(db, resources, net, source="edge1",
                              input_bytes=4.0 * np.prod(SHAPE))
    configs = engine.run(core.Query(top_n=8)).configs
    return [(tuple((s.resource, s.start, s.end) for s in c.segments),
             c.latency_s, c.transfer_bytes, c.describe()) for c in configs]


def test_graph_structure_matches(graphs):
    jg, tg = graphs
    assert tg.partition_points() == jg.partition_points()
    jb, tb = jcore.fuse_blocks(jg), tcore.fuse_blocks(tg)
    assert [b.node_ids for b in tb] == [b.node_ids for b in jb]
    assert [b.output_bytes for b in tb] == [b.output_bytes for b in jb]
    assert [b.flops for b in tb] == [b.flops for b in jb]
    assert [b.param_bytes for b in tb] == [b.param_bytes for b in jb]
    assert [n.out_spec.shape for n in tg.nodes] == \
        [tuple(n.out_spec.shape) for n in jg.nodes]


@pytest.mark.parametrize("shape,jdtype,tdtype", [
    ((1, 4096, 32, 80), jnp.bfloat16, torch.bfloat16),
    ((3, 7), jnp.float32, torch.float32),
    ((2, 5, 9), jnp.int32, torch.int32),
])
def test_output_bytes_match_shape_dtype_struct(shape, jdtype, tdtype):
    jg = jcore.LayerGraph("g")
    jg.input(jax.ShapeDtypeStruct(shape, jdtype))
    tg = tcore.LayerGraph("g")
    tg.input(tcore.TensorSpec(shape, tdtype))
    assert tg.nodes[0].output_bytes == jg.nodes[0].output_bytes


def test_analytic_db_is_identical_and_loads_in_jax(graphs):
    jg, tg = graphs
    jres = _resources(jcore, J_EDGE, J_CLOUD_VM)
    tres = _resources(tcore, EDGE_BOX_1, CLOUD_VM)
    jdb = jcore.benchmark_model(jg, jres, jcore.AnalyticProvider(),
                                batch_sizes=(1, 4))
    tdb = tcore.benchmark_model(tg, tres, tcore.AnalyticProvider(),
                                batch_sizes=(1, 4))
    assert tdb.to_json() == jdb.to_json()
    loaded = JaxBenchmarkDB.from_json(tdb.to_json())
    assert _ranked(jcore, loaded, jres) == _ranked(tcore, tdb, tres)


def test_timed_db_loads_in_jax_with_same_query():
    """A DB the port measured (CPU, tuned) keeps its tuned_params and ranks
    identically when the JAX package loads and queries it."""
    tg = _torch_graph(_weights())
    tres = _resources(tcore, EDGE_BOX_1, CLOUD_VM)
    tuner = KernelAutotuner(
        candidates={"flash_attention": [{"block_q": 32, "block_k": 32}],
                    "ssd_scan": [{"chunk": 32}]}, runs=1, device="cpu")
    tdb = tcore.benchmark_model(
        tg, tres, tcore.TimingProvider(tuner=tuner, device="cpu"), runs=1)
    loaded = JaxBenchmarkDB.from_json(tdb.to_json())
    jres = _resources(jcore, J_EDGE, J_CLOUD_VM)
    assert _ranked(jcore, loaded, jres) == _ranked(tcore, tdb, tres)
    tuned = [r.tuned_params for r in loaded.records["cloud"]]
    assert tuned == [r.tuned_params for r in tdb.records["cloud"]]
    assert {"attn", "ssd"} <= {k for t in tuned for k in t}
    back = tcore.BenchmarkDB.from_json(jcore.BenchmarkDB.to_json(loaded))
    assert back.to_json() == tdb.to_json()


def _closure_params(fn):
    return inspect.getclosurevars(fn).nonlocals["p"]


def _hook(fn, args):
    """Deterministic cost: block_q 64 / block_k 128 / chunk 64 win."""
    p = _closure_params(fn)
    if "chunk" in p:
        return 1.0 + abs(p["chunk"] - 64)
    return 1.0 + abs(p["block_q"] - 64) + abs(p["block_k"] - 128) / 2


def test_autotuners_pick_identical_params():
    jg, tg = _jax_graph(_weights()), _torch_graph(_weights())
    jt = JaxAutotuner(measure=_hook)
    tt = KernelAutotuner(measure=_hook, device="cpu")
    for res in ("edge1", "cloud"):
        for jb, tb in zip(jcore.fuse_blocks(jg), tcore.fuse_blocks(tg)):
            jrecs = jt.tune_block(jb, resource=res)
            trecs = tt.tune_block(tb, resource=res)
            assert [r.params for r in trecs] == [r.params for r in jrecs]
            assert [r.shape_key for r in trecs] == \
                [r.shape_key for r in jrecs]
            assert tt.params_for_block(tb) == jt.params_for_block(jb)
    assert {n.name: n.kernel_params for n in tg.nodes if n.kernel} == \
        {"attn": {"block_q": 64, "block_k": 128}, "ssd": {"chunk": 64}}
    records = json.loads(tt.to_json())
    assert set(records[0]) == set(json.loads(jt.to_json())[0])
    back = KernelAutotuner.from_json(tt.to_json(), device="cpu")
    assert back.records.keys() == tt.records.keys()


def test_two_segment_pipeline_matches_jax(graphs):
    jg, tg = graphs
    rng = np.random.default_rng(1)
    x = rng.standard_normal(SHAPE).astype(np.float32)
    net_j = jcore.NetworkModel(default=jcore.Link("wired", 0.005, 1e8))
    net_t = tcore.NetworkModel(default=tcore.Link("wired", 0.005, 1e8))

    def config(core):
        segs = (core.Segment("edge1", 0, 1), core.Segment("cloud", 2, 3))
        return core.PartitionConfig("autotune-demo", segs, 0.0, {}, 0.0,
                                    0.0)

    jy, jt = JaxExecutor(jg, config(jcore), net_j, source="edge1").run(
        x, collect_timing=True)
    ty, tt = PipelineExecutor(tg, config(tcore), net_t, source="edge1",
                              device="cpu").run(torch.from_numpy(x),
                                                collect_timing=True)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=2e-5,
                               atol=2e-5)
    assert [(t.resource, t.bytes_in, t.comm_in_s) for t in tt] == \
        [(t.resource, t.bytes_in, t.comm_in_s) for t in jt]


def test_convert_keeps_keys_dtypes_and_bf16_bits():
    tree = {"a": {"w": np.asarray(jnp.arange(6, dtype=jnp.bfloat16) / 3)},
            "b": [np.arange(4, dtype=np.int32), np.ones((2, 2), np.float32)],
            "c": (np.float32(2.5),)}
    out = to_torch(tree, "cpu")
    assert out["a"]["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        out["a"]["w"].view(torch.int16).numpy(),
        tree["a"]["w"].view(np.int16))
    assert out["b"][0].dtype == torch.int32 and out["b"][1].dtype == \
        torch.float32
    assert isinstance(out["c"], tuple) and out["c"][0].item() == 2.5
    assert array_to_tensor(np.zeros((3,), np.float16), "cpu").dtype == \
        torch.float16
