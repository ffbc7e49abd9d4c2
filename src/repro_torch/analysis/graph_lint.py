"""Graph IR checker (SCN3xx): LayerGraph well-formedness.

Turns ``LayerGraph`` malformations into named-node :class:`Diagnostic` s
instead of a terse ``ValueError`` naming a node *index*:

* structural well-formedness — non-empty, acyclic (predecessor indices
  strictly earlier: the topological-insertion invariant), no dangling
  predecessor indices, exactly one sink (the last node), no orphan
  sources beyond the input node, every non-input node callable;
* series-parallel structure (SCN309/SCN310) of branchy graphs.

``LayerGraph.validate`` raises :class:`GraphLintError` (a ``ValueError``
subclass, so ``except ValueError`` call sites keep working) that carries
the full diagnostic list; ``fuse_blocks`` runs through it.
"""

from __future__ import annotations

from typing import Any

from .diagnostics import Diagnostic, ERROR, errors, render_report


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


def lint_graph(graph: Any) -> list[Diagnostic]:
    """Well-formedness diagnostics for a
    :class:`repro_torch.core.graph.LayerGraph`."""
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
