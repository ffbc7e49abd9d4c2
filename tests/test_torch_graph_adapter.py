"""The port's graph adapters against the JAX package's, on the CPU.

``lm_to_graph``: both packages adapt the same reduced LM (granite-8b,
gemma2-9b and zamba2-2.7b cut as tests/test_models_smoke.py cuts them, fp32
parameters drawn by the JAX model and carried over by
``convert.to_torch``) at batch 2, sequence 16.  Node names, kinds, output
bytes, FLOPs, parameter bytes and partition points must be equal; the
port's graph run block by block (its kernels' plain versions on the CPU)
must give the JAX graph's head logits at 1e-4 absolute plus relative, and
a two-stage ``PipelineExecutor`` run the whole graph's bit for bit.

The DAG adapters (``encdec_to_graph`` on a reduced whisper-medium,
``moe_to_graph`` on bench_partitions.py's MoE layer, ``xlstm_to_graph`` on
a reduced xlstm-125m): the same nodes, edges, bytes, FLOPs and partition
points, the same ``fuse_block_dag`` blocks, block edges, parallel regions
and collapsed regions; node-by-node outputs at 1e-4 (the MoE layer's bf16
output at 1e-2, as tests/test_dag_partition.py holds it), and a
``DagPipelineExecutor`` run with the DAG blocks on two resources in turn
equal to the whole graph bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jax

from repro.core.graph import fuse_block_dag as jax_fuse_dag
from repro.core.graph import fuse_blocks as jax_fuse
from repro.models import build_model as jax_build
from repro.models import get_config as jax_config
from repro.models import graph_adapter as jga
from repro.models import layers as JL
from repro.models.graph_adapter import lm_to_graph as jax_lm_to_graph
from repro.models.moe import moe_spec

from repro_torch.convert import to_torch
from repro_torch.core import Link, NetworkModel, fuse_block_dag, fuse_blocks
from repro_torch.core.lattice.chain import PartitionConfig, Segment
from repro_torch.models import build_model, get_config
from repro_torch.models import graph_adapter as tga
from repro_torch.models.graph_adapter import lm_to_graph
from repro_torch.runtime import DagPipelineExecutor, PipelineExecutor
from test_models_smoke import reduce_cfg as smoke_reduce
from test_torch_lm import _models, jax_params

B, S = 2, 16


@pytest.mark.parametrize("arch", ["granite-8b", "gemma2-9b", "zamba2-2.7b"])
def test_lm_to_graph_matches_jax(arch):
    _, jmodel, jp, tmodel, tp = _models(arch, "float32")
    jg = jax_lm_to_graph(jmodel, jp, batch=B, seq_len=S)
    tg = lm_to_graph(tmodel, tp, batch=B, seq_len=S)
    assert [(n.name, n.kind) for n in tg.nodes] == \
        [(n.name, n.kind) for n in jg.nodes]
    assert [n.output_bytes for n in tg.nodes] == \
        [n.output_bytes for n in jg.nodes]
    assert [n.flops for n in tg.nodes] == [n.flops for n in jg.nodes]
    assert [n.param_bytes for n in tg.nodes] == \
        [n.param_bytes for n in jg.nodes]
    assert tg.partition_points() == jg.partition_points()
    assert [b.node_ids for b in fuse_blocks(tg)] == \
        [b.node_ids for b in jax_fuse(jg)]

    tokens = np.random.default_rng(7).integers(0, tmodel.cfg.vocab, (B, S),
                                               dtype=np.int32)
    want = jnp.asarray(tokens)
    for blk in jax_fuse(jg):
        want = blk.make_callable()(want)
    got = torch.from_numpy(tokens)
    for blk in fuse_blocks(tg):
        got = blk.make_callable()(got)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=1e-4,
                               atol=1e-4)

    n = len(fuse_blocks(tg))
    cfg = PartitionConfig(
        model=tg.name, segments=(Segment("edge", 0, n // 2),
                                 Segment("cloud", n // 2 + 1, n - 1)),
        latency_s=0.0, compute_s={}, comm_s=0.0, transfer_bytes=0.0)
    net = NetworkModel(default=Link("wired", 0.005, 1e8))
    y, timings = PipelineExecutor(tg, cfg, net, source="edge",
                                  device="cpu").run(
        torch.from_numpy(tokens), collect_timing=True)
    assert len(timings) == 2 and torch.equal(y, got)


def _same_structure(tg, jg):
    """Nodes, edges, bytes, FLOPs, partition points and the DAG fusion."""
    assert [(n.name, n.kind) for n in tg.nodes] == \
        [(n.name, n.kind) for n in jg.nodes]
    assert [list(p) for p in tg.preds] == [list(p) for p in jg.preds]
    assert [n.output_bytes for n in tg.nodes] == \
        [n.output_bytes for n in jg.nodes]
    assert [n.flops for n in tg.nodes] == [n.flops for n in jg.nodes]
    assert [n.param_bytes for n in tg.nodes] == \
        [n.param_bytes for n in jg.nodes]
    assert tg.partition_points() == jg.partition_points()
    td, jd = fuse_block_dag(tg), jax_fuse_dag(jg)
    assert [b.node_ids for b in td] == [b.node_ids for b in jd]
    assert td.preds == jd.preds
    assert td.parallel_regions == jd.parallel_regions and td.parallel_regions
    assert td.collapsed == jd.collapsed == []
    return td


def _run_nodes(g, x):
    """Every node applied in order to its predecessors' outputs."""
    vals = [x]
    for i in range(1, len(g.nodes)):
        vals.append(g.nodes[i].apply(*[vals[p] for p in g.preds[i]]))
    return vals[-1]


def _dag_run_equals_whole(tg, td, x, want):
    """The DAG blocks on "edge" and "cloud" in turn, so that branch and
    skip edges cross resources: the output equals ``want`` bit for bit."""
    cfg = PartitionConfig(
        model=tg.name, segments=tuple(
            Segment(("edge", "cloud")[i % 2], i, i) for i in range(len(td))),
        latency_s=0.0, compute_s={}, comm_s=0.0, transfer_bytes=0.0)
    net = NetworkModel(default=Link("wired", 0.005, 1e8))
    y, timings = DagPipelineExecutor(tg, cfg, net, source="edge",
                                     device="cpu").run(x, collect_timing=True)
    assert len(timings) == len(td) and torch.equal(y, want)


def test_encdec_to_graph_matches_jax():
    jcfg = smoke_reduce(jax_config("whisper-medium"))
    jmodel = jax_build(jcfg)
    np_params = jax_params(jmodel, "float32")
    jp = jax.tree.map(jnp.asarray, np_params)
    tmodel = build_model(smoke_reduce(get_config("whisper-medium")),
                         device="cpu")
    tp = to_torch(np_params, "cpu")
    jg = jga.encdec_to_graph(jmodel, jp, batch=1, seq_len=8, enc_splits=2)
    tg = tga.encdec_to_graph(tmodel, tp, batch=1, seq_len=8, enc_splits=2)
    td = _same_structure(tg, jg)
    tokens = np.random.default_rng(8).integers(0, jcfg.vocab, (1, 8),
                                               dtype=np.int32)
    want = _run_nodes(jg, jnp.asarray(tokens))
    got = _run_nodes(tg, torch.from_numpy(tokens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    _dag_run_equals_whole(tg, td, torch.from_numpy(tokens), got)


def test_moe_to_graph_matches_jax():
    np_params = jax.tree.map(np.asarray, JL.init_tree(
        moe_spec(32, 64, 4), jax.random.PRNGKey(0), jnp.float32))
    kw = dict(batch=1, seq_len=8, d_model=32, n_experts=4, top_k=2,
              n_shards=2)
    jg = jga.moe_to_graph(jax.tree.map(jnp.asarray, np_params), **kw)
    tg = tga.moe_to_graph(to_torch(np_params, "cpu"), **kw)
    td = _same_structure(tg, jg)
    x = np.random.default_rng(9).standard_normal((1, 8, 32)).astype(
        np.float32)
    want = _run_nodes(jg, jnp.asarray(x).astype(jnp.bfloat16))
    tx = torch.from_numpy(x).to(torch.bfloat16)
    got = _run_nodes(tg, tx)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=1e-2,
                               atol=1e-2)
    _dag_run_equals_whole(tg, td, tx, got)


def test_xlstm_to_graph_matches_jax():
    _, jmodel, jp, tmodel, tp = _models("xlstm-125m", "float32")
    jg = jga.xlstm_to_graph(jmodel, jp, batch=B, seq_len=S)
    tg = tga.xlstm_to_graph(tmodel, tp, batch=B, seq_len=S)
    td = _same_structure(tg, jg)
    tokens = np.random.default_rng(10).integers(0, tmodel.cfg.vocab, (B, S),
                                                dtype=np.int32)
    want = _run_nodes(jg, jnp.asarray(tokens))
    got = _run_nodes(tg, torch.from_numpy(tokens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    _dag_run_equals_whole(tg, td, torch.from_numpy(tokens), got)
