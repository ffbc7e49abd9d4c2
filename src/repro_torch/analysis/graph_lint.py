"""Graph IR checker (SCN3xx): LayerGraph well-formedness.

Turns ``LayerGraph`` malformations into named-node :class:`Diagnostic` s
instead of a terse ``ValueError`` naming a node *index*:

* structural well-formedness — non-empty, acyclic (predecessor indices
  strictly earlier: the topological-insertion invariant), no dangling
  predecessor indices, exactly one sink (the last node), no orphan
  sources beyond the input node, every non-input node callable;
* shape-chain consistency (``check_shapes=True``, traced graphs only) —
  each node's declared ``out_spec`` must equal the spec recomputed from its
  predecessors' ``out_spec`` s by running its ``apply`` on ``meta``
  tensors (SCN306), so a stale or hand-edited spec is caught at the node
  that declares it;
* series-parallel structure (SCN309/SCN310) of branchy graphs;
* benchmark cross-check (:func:`lint_db_against_graph`, SCN307) — a DB's
  recorded per-block output bytes must match the graph the blocks were
  fused from.

``LayerGraph.validate`` raises :class:`GraphLintError` (a ``ValueError``
subclass, so ``except ValueError`` call sites keep working) that carries
the full diagnostic list; ``fuse_blocks`` runs through it.
"""

from __future__ import annotations

from typing import Any

from .diagnostics import Diagnostic, ERROR, INFO, errors, render_report


class GraphLintError(ValueError):
    """Raised by ``LayerGraph.validate`` when the checker finds errors.

    Subclasses ``ValueError`` for drop-in compatibility with the previous
    ad-hoc raises; ``diagnostics`` carries every finding (not only the
    first), each naming the offending node.
    """

    def __init__(self, title: str, diagnostics: list[Diagnostic]):
        self.diagnostics = list(diagnostics)
        super().__init__(render_report(self.diagnostics, title))


def _name(graph: Any, i: int) -> str:
    if 0 <= i < len(graph.nodes):
        return f"{graph.nodes[i].name!r} (node {i})"
    return f"node {i}"


def lint_graph(graph: Any, *, check_shapes: bool = False) -> list[Diagnostic]:
    """Well-formedness diagnostics for a
    :class:`repro_torch.core.graph.LayerGraph`.

    With ``check_shapes=True`` the declared ``out_spec`` of every traced
    node is re-derived from its predecessors and compared (SCN306); an
    untraced graph gets a single SCN308 info instead.
    """
    diags: list[Diagnostic] = []
    n = len(graph.nodes)
    if n == 0:
        return [Diagnostic("SCN301", ERROR,
                           f"graph {graph.name!r} is empty",
                           subject=graph.name,
                           hint="add an input node first (graph.input(spec))")]

    # SCN302 — dangling / non-topological predecessor indices.  add()
    # enforces this at insert time, but graphs are plain lists and adapters
    # may rewrite preds; a violation here also rules out every later check
    # that walks the edges, so report and stop early.
    bad_edges = False
    for i, ps in enumerate(graph.preds):
        for p in ps:
            if not 0 <= p < i:
                bad_edges = True
                what = "dangling" if not 0 <= p < n else \
                    "non-topological (would create a cycle)"
                diags.append(Diagnostic(
                    "SCN302", ERROR,
                    f"{_name(graph, i)} has {what} predecessor index {p}",
                    subject=graph.nodes[i].name,
                    hint="predecessors must be strictly earlier nodes"))
    if bad_edges:
        return diags

    succs = graph.succs
    sinks = [i for i, s in enumerate(succs) if not s]
    for i in sinks:
        if i != n - 1:
            diags.append(Diagnostic(
                "SCN303", ERROR,
                f"{_name(graph, i)} has no successors but is not the final "
                f"node; a LayerGraph has exactly one sink (the last node)",
                subject=graph.nodes[i].name,
                hint="connect the node forward, or drop it"))
    for i in range(1, n):
        if not graph.preds[i]:
            diags.append(Diagnostic(
                "SCN304", ERROR,
                f"{_name(graph, i)} is an orphan source; only node 0 (the "
                "input) may have no predecessors",
                subject=graph.nodes[i].name,
                hint="pass preds=[...] when adding the node"))
        if graph.nodes[i].apply is None:
            diags.append(Diagnostic(
                "SCN305", ERROR,
                f"{_name(graph, i)} has no apply function",
                subject=graph.nodes[i].name,
                hint="every non-input node needs a callable apply"))

    if check_shapes and not errors(diags):
        if any(node.out_spec is None for node in graph.nodes):
            diags.append(Diagnostic(
                "SCN308", INFO,
                f"graph {graph.name!r} is untraced: shape-chain checks "
                "skipped", subject=graph.name,
                hint="call graph.trace() first"))
        else:
            diags.extend(_lint_shape_chain(graph))
    if not errors(diags):
        diags.extend(_lint_sp_structure(graph))
    return diags


def _lint_sp_structure(graph: Any) -> list[Diagnostic]:
    """SCN309/SCN310: series-parallel structure of a branchy graph.

    * SCN309 — a region is **not series-parallel** (a branch exits through
      more than one node, or crossing skips leave no fork-join shape):
      ``fuse_block_dag`` linearises it into one block, so no cut can land
      inside it.  Names the offending subgraph's nodes.
    * SCN310 — the graph has a parallel region but chain fusing
      (``fuse_blocks``) is in use semantics-wise: any consumer that fuses
      this graph as a chain collapses the region into a single block and
      the branch-placement freedom is silently lost.  Emitted whenever a
      parallel region exists and the chain fusing would merge its nodes
      into one block — i.e. always, since chain cuts cannot enter a
      multi-producer region.

    Both are WARNINGs: the graph is well-formed either way; only the
    partitioner's freedom is affected.
    """
    from .diagnostics import WARNING

    diags: list[Diagnostic] = []
    from ..core.graph import sp_summary
    parallel_regions, collapsed = sp_summary(graph)
    for seg in collapsed:
        names = ", ".join(graph.nodes[i].name for i in seg[:6])
        if len(seg) > 6:
            names += f", … ({len(seg)} nodes)"
        diags.append(Diagnostic(
            "SCN309", WARNING,
            f"graph {graph.name!r}: subgraph [{names}] is not "
            "series-parallel; fuse_block_dag linearises it into one block "
            "and no partition point can land inside it",
            subject=graph.nodes[seg[0]].name,
            hint="restructure crossing skip connections into nested "
                 "fork-join regions to expose its cut points"))
    if parallel_regions:
        total = sum(len(r) for r in parallel_regions)
        diags.append(Diagnostic(
            "SCN310", WARNING,
            f"graph {graph.name!r} has {len(parallel_regions)} parallel "
            f"region(s) ({total} branch nodes) that chain fusing "
            "(fuse_blocks) collapses into single blocks, discarding "
            "branch-placement freedom",
            subject=graph.name,
            hint="fuse with fuse_block_dag / benchmark(dag=True) to "
                 "partition branches across resources"))
    return diags


def _lint_shape_chain(graph: Any) -> list[Diagnostic]:
    """SCN306: re-derive each node's out_spec from its predecessors'
    declared specs, on ``meta`` tensors, and compare.  Runs node-at-a-time
    so a mismatch is reported at the node that *declares* the stale spec,
    not at the first downstream consumer that trips over it."""
    import torch

    diags: list[Diagnostic] = []
    for i in range(1, len(graph.nodes)):
        node = graph.nodes[i]
        ins = [torch.empty(graph.nodes[p].out_spec.shape,
                           dtype=graph.nodes[p].out_spec.dtype, device="meta")
               for p in graph.preds[i]]
        try:
            computed = node.apply(*ins)
        except Exception as e:                      # noqa: BLE001
            diags.append(Diagnostic(
                "SCN306", ERROR,
                f"{_name(graph, i)}: apply does not accept its "
                f"predecessors' out_specs ({type(e).__name__}: {e})",
                subject=node.name,
                hint="the upstream node's out_spec is probably stale"))
            continue
        declared = node.out_spec
        if (tuple(computed.shape) != tuple(declared.shape)
                or computed.dtype != declared.dtype):
            diags.append(Diagnostic(
                "SCN306", ERROR,
                f"{_name(graph, i)} declares out_spec "
                f"{tuple(declared.shape)}/{declared.dtype} but its "
                f"predecessors' specs compute "
                f"{tuple(computed.shape)}/{computed.dtype}",
                subject=node.name,
                hint="re-run graph.trace() after editing the graph"))
    return diags


def lint_db_against_graph(db: Any, blocks: list[Any]) -> list[Diagnostic]:
    """SCN307: a benchmark DB's recorded output bytes vs the graph's
    computed ones — catches a DB paired with the wrong (or since-edited)
    model graph before its transfer costs poison a solve."""
    from .diagnostics import WARNING

    diags: list[Diagnostic] = []
    if db.n_blocks != len(blocks):
        diags.append(Diagnostic(
            "SCN307", WARNING,
            f"DB for model {db.model!r} records {db.n_blocks} blocks but "
            f"the graph fuses into {len(blocks)}",
            subject=db.model,
            hint="re-run benchmark_model against the current graph"))
        return diags
    for i, blk in enumerate(blocks):
        recorded = float(db.output_bytes(i))
        computed = float(blk.output_bytes)
        if recorded != computed:
            diags.append(Diagnostic(
                "SCN307", WARNING,
                f"block {i} ({blk.name}): DB records "
                f"{recorded:.0f} output bytes but the graph computes "
                f"{computed:.0f}", subject=blk.name,
                hint="re-run benchmark_model against the current graph"))
    return diags
