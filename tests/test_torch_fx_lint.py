"""The port's FX dataflow lint (``repro_torch.analysis.fx_lint``, SCN5xx)
held against the JAX package's jaxpr lint on the CPU.

Each case builds the same graph in both packages from one numpy seed and
requires the same diagnostic codes, severities and subjects.  The torch form
of a case stands in for the JAX one where the mechanism differs: ``.item()``
for ``jax.debug.callback``, a ``.cpu()``/numpy round-trip for the
host-concretising apply.  The demo graph runs the JAX kernels in interpret
mode, as ``tests/test_cost_lint.py`` does.  SCN501 is held on the port
alone: the reference's own SCN501 case needs x64 mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis.jaxpr_lint import lint_block as jlint_block
from repro.analysis.jaxpr_lint import lint_blocks as jlint_blocks
from repro.core import linear_graph as jlinear_graph
from repro.core.bench import AnalyticProvider as JAnalytic
from repro.core.bench import benchmark_model as jbenchmark
from repro.core.graph import LayerNode as JNode
from repro.core.graph import fuse_blocks as jfuse
from repro.core.resources import CLOUD_VM as JCLOUD
from repro.core.resources import Resource as JResource

from repro_torch.analysis import fx_lint
from repro_torch.analysis.diagnostics import ERROR, WARNING
from repro_torch.analysis.fx_lint import lint_block, lint_blocks
from repro_torch.core import LayerNode, Resource, TensorSpec, linear_graph
from repro_torch.core.bench import AnalyticProvider, benchmark_model
from repro_torch.core.graph import fuse_blocks
from repro_torch.core.resources import CLOUD_VM

D = 8
W = np.random.default_rng(0).standard_normal((D, D)).astype(np.float32) * 0.5


def _key(diags):
    return sorted((d.code, d.severity, d.subject) for d in diags)


def _jnode(name, apply=None, kernel=None):
    w = jnp.asarray(W)
    return JNode(name=name, kind="attention" if kernel else "dense",
                 apply=apply or (lambda x: jnp.tanh(x @ w)),
                 flops=2.0 * D * D, kernel=kernel)


def _tnode(name, apply=None, kernel=None):
    w = torch.from_numpy(W)
    return LayerNode(name=name, kind="attention" if kernel else "dense",
                     apply=apply or (lambda x: torch.tanh(x @ w.to(x.device))),
                     flops=2.0 * D * D, kernel=kernel)


def _jgraph(*nodes):
    return jlinear_graph("g", jax.ShapeDtypeStruct((1, 4, D), jnp.float32),
                         list(nodes))


def _tgraph(*nodes):
    return linear_graph("g", TensorSpec((1, 4, D), torch.float32),
                        list(nodes))


def test_clean_dense_chain():
    j = jlint_blocks(jfuse(_jgraph(_jnode("a"), _jnode("b"))))
    t = lint_blocks(fuse_blocks(_tgraph(_tnode("a"), _tnode("b"))))
    assert j == [] and t == []


def test_scn502_on_a_tampered_db():
    jg, tg = _jgraph(_jnode("a")), _tgraph(_tnode("a"))
    jb, tb = list(jfuse(jg)), list(fuse_blocks(tg))
    jdb = jbenchmark(jg, [JResource("cloud", "cloud", JCLOUD)], JAnalytic(),
                     runs=1, blocks=jb)
    tdb = benchmark_model(tg, [Resource("cloud", "cloud", CLOUD_VM)],
                          AnalyticProvider(), runs=1, blocks=tb)
    assert jlint_block(jb[0], db=jdb) == [] and lint_block(tb[0], db=tdb) == []
    jdb.records["cloud"][0].output_bytes += 64
    tdb.records["cloud"][0].output_bytes += 64
    j, t = jlint_block(jb[0], db=jdb), lint_block(tb[0], db=tdb)
    assert _key(t) == _key(j) == [("SCN502", WARNING, j[0].subject)]
    assert "BenchmarkDB.output_bytes" in t[0].message
    assert f"charges {128 + 64}" in t[0].message


def test_scn503_host_round_trip():
    def japply(x):
        jax.debug.callback(lambda v: None, x.sum())
        return x * 2.0

    def tapply(x):
        x.sum().item()
        return x * 2.0

    j = jlint_blocks(jfuse(_jgraph(_jnode("cb", apply=japply))))
    # the port's graph traces on meta as it is built, where .item() raises:
    # the node takes its host read after the trace
    tg = _tgraph(_tnode("cb"))
    tg.nodes[1].apply = tapply
    t = lint_blocks(fuse_blocks(tg))
    assert _key(t) == _key(j)
    assert [(d.code, d.severity) for d in t] == [("SCN503", ERROR)]


def test_scn503_host_concretising_apply_swapped_after_the_trace():
    jg, tg = _jgraph(_jnode("a")), _tgraph(_tnode("a"))
    jg.nodes[1].apply = lambda x: jnp.asarray(np.asarray(x) + 1.0)
    tg.nodes[1].apply = lambda x: torch.from_numpy(x.cpu().numpy() + 1.0)
    j, t = jlint_blocks(jfuse(jg)), lint_blocks(fuse_blocks(tg))
    assert _key(t) == _key(j) and [d.code for d in t] == ["SCN503"]
    assert "abstract tracing" in t[0].message


@pytest.mark.parametrize("kernel", ["flash_attention", None])
def test_scn504_only_on_a_kernel_bearing_block(kernel):
    wj, wt = jnp.asarray(W, jnp.bfloat16), torch.from_numpy(W).bfloat16()

    def japply(x):
        return (x.astype(jnp.bfloat16) @ wj).astype(jnp.float32)

    def tapply(x):
        return (x.bfloat16() @ wt.to(x.device)).float()

    j = jlint_blocks(jfuse(_jgraph(_jnode("k", japply, kernel))))
    t = lint_blocks(fuse_blocks(_tgraph(_tnode("k", tapply, kernel))))
    assert _key(t) == _key(j)
    assert [(d.code, d.severity) for d in t] == \
        ([("SCN504", WARNING)] if kernel else [])


def test_kernel_demo_graph_is_clean_in_both():
    from repro.kernels.ops import flash_attention_node as jflash
    from repro.kernels.ops import ssd_scan_node as jssd

    from repro_torch.kernels.ops import flash_attention_node, ssd_scan_node
    jg = jlinear_graph("demo", jax.ShapeDtypeStruct((1, 128, 2, 32),
                                                    jnp.float32),
                       [jflash("attn", interpret=True),
                        jssd("ssd", state_dim=16, interpret=True)])
    tg = linear_graph("demo", TensorSpec((1, 128, 2, 32), torch.float32),
                      [flash_attention_node("attn", device="cpu"),
                       ssd_scan_node("ssd", state_dim=16, device="cpu")])
    assert jlint_blocks(jfuse(jg)) == [] and lint_blocks(fuse_blocks(tg)) == []


def test_mobilenetv2_blocks_are_clean_in_both():
    import repro.models.cnn_zoo as jzoo

    from repro_torch.models import cnn_zoo
    tb = fuse_blocks(cnn_zoo.build("MobileNetV2", "meta"))
    jb = jfuse(jzoo.mobilenetv2())
    assert len(tb) == len(jb)
    assert lint_blocks(tb) == [] and jlint_blocks(jb) == []


def test_scn501_float64_leakage():
    t = lint_blocks(fuse_blocks(_tgraph(_tnode(
        "f64", apply=lambda x: (x.double() * 2.0).float()))))
    assert [(d.code, d.severity) for d in t] == [("SCN501", WARNING)]
    assert "float64" in t[0].message and "aten._to_copy" in t[0].message


def test_host_sync_ops_in_a_trace_are_recognised():
    """A trace that does record a host read (the ops ``.item()``, boolean
    indexing and ``unique`` dispatch to) is SCN503: each is recognised by
    its aten op; a copy is one only when it lands on the CPU."""
    aten = torch.ops.aten

    def fn(x):
        aten._local_scalar_dense.default(x)
        aten.nonzero.default(x)
        aten._unique2.default(x)
        return aten.mul.Tensor(x, 2.0)

    gm = torch.fx.symbolic_trace(fn)
    flagged = [fx_lint._op(n) for n in gm.graph.nodes
               if n.op == "call_function" and fx_lint._is_host_sync(n)]
    assert flagged == ["aten._local_scalar_dense", "aten.nonzero",
                       "aten._unique2"]
