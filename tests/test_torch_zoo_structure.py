"""The port's CNN zoo against the JAX package's, in structure, on the CPU.

For the nets in ``NETS`` (the 18 are split over this file and
``test_torch_zoo_structure_cells.py``, so that two workers share the JAX
builds of 6-14 s a net), the port's graph built on
``meta`` has the same nodes (names, kinds, every ``out_spec``), layer count,
partition points, chain and DAG blocks, block output bytes, FLOPs and
parameter bytes as the JAX graph; ``LINEAR``/``APPROX`` agree; the SCN306
shape check and the SCN307 DB check report what the JAX package reports;
and ``CompiledCostProvider`` counts the graph-declared FLOPs of every block,
and the same bytes whether the weights live on the CPU or on ``meta``.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.core as jcore
from repro.analysis.graph_lint import lint_db_against_graph as j_lint_db
from repro.analysis.graph_lint import lint_graph as j_lint_graph
from repro.models import cnn_zoo as jzoo

import repro_torch.core as tcore
from repro_torch.analysis.graph_lint import lint_db_against_graph, lint_graph
from repro_torch.models import cnn_zoo

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))   # benchmarks/

NETS = ["VGG16", "VGG19", "ResNet50", "ResNet101", "ResNet152",
        "ResNet50V2", "ResNet101V2", "ResNet152V2", "MobileNet",
        "MobileNetV2"]

_JAX: dict = {}


def jax_graph(name):
    """One JAX build per net and worker."""
    if name not in _JAX:
        _JAX[name] = jzoo.build(name)
    return _JAX[name]


def _blocks(core, graph):
    return [(b.node_ids, b.output_bytes, b.flops, b.param_bytes)
            for b in core.fuse_blocks(graph)]


def check_structure(name):
    jg, tg = jax_graph(name), cnn_zoo.build(name, "meta")
    assert tg.name == jg.name and tg.n_layers == jg.n_layers
    assert [(n.name, n.kind) for n in tg.nodes] == \
        [(n.name, n.kind) for n in jg.nodes]
    assert tg.preds == jg.preds
    assert [n.out_spec.shape for n in tg.nodes] == \
        [tuple(n.out_spec.shape) for n in jg.nodes]
    assert all(n.out_spec.dtype == torch.float32 for n in tg.nodes)
    assert all(str(n.out_spec.dtype) == "float32" for n in jg.nodes)
    assert [n.flops for n in tg.nodes] == [n.flops for n in jg.nodes]
    assert [n.param_bytes for n in tg.nodes] == \
        [n.param_bytes for n in jg.nodes]
    assert tg.partition_points() == jg.partition_points()
    assert _blocks(tcore, tg) == _blocks(jcore, jg)
    assert (name in cnn_zoo.LINEAR) == (name in jzoo.LINEAR)
    assert (name in cnn_zoo.APPROX) == (name in jzoo.APPROX)


def check_block_dag(name):
    jd = jcore.fuse_block_dag(jax_graph(name))
    td = tcore.fuse_block_dag(cnn_zoo.build(name, "meta"))
    assert [b.node_ids for b in td] == [b.node_ids for b in jd]
    assert td.preds == jd.preds
    assert td.parallel_regions == jd.parallel_regions
    assert td.collapsed == jd.collapsed


@pytest.mark.parametrize("name", NETS)
def test_zoo_net_structure_matches_jax(name):
    check_structure(name)


@pytest.mark.parametrize("name", NETS)
def test_zoo_net_block_dag_matches_jax(name):
    check_block_dag(name)


def test_zoo_tables_match_jax():
    assert list(cnn_zoo.ZOO) == list(jzoo.ZOO)
    assert cnn_zoo.LINEAR == jzoo.LINEAR and cnn_zoo.APPROX == jzoo.APPROX


def _codes(diags):
    return [(d.code, d.severity, d.subject) for d in diags]


@pytest.mark.parametrize("node", [5, 17])
def test_scn306_stale_spec_matches_jax(node):
    """A hand-edited out_spec is reported at the node that declares it (its
    consumer no longer accepts it, and its own apply disagrees)."""
    import jax
    jg = jzoo.build("MobileNet")
    tg = cnn_zoo.build("MobileNet", "meta")
    shape = tuple(tg.nodes[node].out_spec.shape)
    stale = (shape[0], shape[1] + 1, *shape[2:])
    jg.nodes[node].out_spec = jax.ShapeDtypeStruct(stale, np.float32)
    tg.nodes[node].out_spec = tcore.TensorSpec(stale, torch.float32)
    want = _codes(j_lint_graph(jg, check_shapes=True))
    got = _codes(lint_graph(tg, check_shapes=True))
    assert got == want
    assert ("SCN306", "error", tg.nodes[node].name) in got


def test_scn306_clean_and_untraced_graphs_match_jax():
    jg, tg = jax_graph("VGG16"), cnn_zoo.build("VGG16", "meta")
    assert _codes(lint_graph(tg, check_shapes=True)) == \
        _codes(j_lint_graph(jg, check_shapes=True)) == []
    bare = tcore.LayerGraph("bare")
    bare.input(tcore.TensorSpec((1, 4), torch.float32))
    bare.add(tcore.LayerNode("l", "dense", apply=lambda x: x), [0])
    assert [d.code for d in lint_graph(bare, check_shapes=True)] == \
        ["SCN308"]


def test_scn307_db_with_wrong_bytes_matches_jax():
    from benchmarks import common as jcommon
    from benchmarks import common_torch as tcommon
    jg, tg = jax_graph("ResNet50"), cnn_zoo.build("ResNet50", "meta")
    jdb = jcore.benchmark_model(jg, jcommon.testbed()[:2],
                                jcore.AnalyticProvider(), runs=1)
    tdb = tcore.benchmark_model(tg, tcommon.testbed()[:2],
                                tcore.AnalyticProvider(), runs=1)
    jblocks, tblocks = jcore.fuse_blocks(jg), tcore.fuse_blocks(tg)
    assert lint_db_against_graph(tdb, tblocks) == []
    for db in (jdb, tdb):
        for recs in db.records.values():
            recs[3].output_bytes += 4
    want = _codes(j_lint_db(jdb, jblocks))
    assert _codes(lint_db_against_graph(tdb, tblocks)) == want
    assert [c for c, _, _ in want] == ["SCN307"]
    assert _codes(lint_db_against_graph(tdb, tblocks[:-1])) == \
        _codes(j_lint_db(jdb, jblocks[:-1]))


@pytest.mark.parametrize("name", ["VGG16", "ResNet50", "MobileNetV2"])
def test_compiled_cost_flops_equal_graph_flops(name):
    """FlopCounterMode counts each conv and dense product as the graph
    declares it (2 * k*k * cin/groups per output, 2 * cin per output), and
    nothing else; the bytes are at least each block's input, output and
    parameters, and none for a block of views alone (VGG's flatten)."""
    g = cnn_zoo.build(name, "meta")
    res = tcore.Resource("cloud", "cloud", tcore.H100_SXM)
    prov = tcore.CompiledCostProvider()
    for blk in tcore.fuse_blocks(g):
        t, _, flops, nbytes = prov.measure(blk, res, 1)
        assert flops == blk.flops
        floor = blk.param_bytes + blk.output_bytes + \
            sum(s.nbytes for s in blk.in_specs)
        assert nbytes == 0 if blk.kinds == ["reshape"] else nbytes >= floor
        assert t == tcore.H100_SXM.layer_time(flops, nbytes)


@pytest.mark.parametrize("name", ["MobileNetV2", "ResNet50", "InceptionV3"])
def test_compiled_cost_bytes_do_not_depend_on_where_weights_live(name):
    """Every block's FLOPs and bytes are the same for a CPU build as for a
    ``meta`` build: the ``meta`` stand-ins that a traced module makes of
    weights living elsewhere are not counted as traffic."""
    res = tcore.Resource("cloud", "cloud", tcore.H100_SXM)
    prov = tcore.CompiledCostProvider()
    got = [[prov.measure(b, res, 1)[2:] for b in
            tcore.fuse_blocks(cnn_zoo.build(name, dev))]
           for dev in ("meta", "cpu")]
    assert got[0] == got[1]


@pytest.mark.parametrize("act,reads", [(None, 0), ("relu", 2),
                                       ("softmax", 2)])
def test_compiled_cost_bytes_count_each_operator_once(act, reads):
    """A CPU-built conv and dense, each alone: the input, the weight and
    the bias are counted once, the output once as the product's result,
    and again as the activation's read and write (``reads``)."""
    res = tcore.Resource("cloud", "cloud", tcore.H100_SXM)
    g = cnn_zoo.ZooGraph("t", torch.device("cpu"), 0)
    prev = g.input(tcore.TensorSpec((1, 9, 9, 4), torch.float32))
    if act == "softmax":
        prev = g.add(g.flatten(), [prev])
        prev = g.add(g.dense("l", 9 * 9 * 4, 10, act=act), [prev])
    else:
        prev = g.add(g.conv("l", 4, 6, act=act), [prev])
    g.trace()
    (blk,) = [b for b in tcore.fuse_blocks(g)
              if {"conv", "dense"} & set(b.kinds)]
    nbytes = tcore.CompiledCostProvider().measure(blk, res, 1)[3]
    assert nbytes == sum(s.nbytes for s in blk.in_specs) + \
        blk.param_bytes + (1 + reads) * blk.output_bytes
