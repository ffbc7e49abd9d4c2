"""The port's ``lm_to_graph`` against the JAX package's, on the CPU.

Both packages adapt the same reduced LM (granite-8b, gemma2-9b and
zamba2-2.7b cut as tests/test_models_smoke.py cuts them, fp32 parameters
drawn by the JAX model and carried over by ``convert.to_torch``) at batch
2, sequence 16.  Node names, kinds, output bytes, FLOPs, parameter bytes
and partition points must be equal; the port's graph run block by block
(its kernels' plain versions on the CPU) must give the JAX graph's head
logits at 1e-4 absolute plus relative, and a two-stage
``PipelineExecutor`` run the whole graph's bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.graph import fuse_blocks as jax_fuse
from repro.models.graph_adapter import lm_to_graph as jax_lm_to_graph

from repro_torch.core import Link, NetworkModel, fuse_blocks
from repro_torch.core.lattice.chain import PartitionConfig, Segment
from repro_torch.models.graph_adapter import lm_to_graph
from repro_torch.runtime import PipelineExecutor
from test_torch_lm import _models

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
