"""Layer-graph IR and partition-point analysis (Scission §II-A, §II-C Step 1-2).

A model is represented as a DAG of :class:`LayerNode` s with a single input
node and a single output node.  Scission's partitioning rules:

* **linear models** — every inter-layer edge is a valid partition point,
  except the edge leaving the input layer (the paper's ``N-2`` rule: a first
  partition holding only the input layer would duplicate the input layer in
  the second partition);
* **branching models** — a cut may never split a parallel region, so layers
  inside a branch are fused into a *block* and treated as a single entity
  (ResNet50: 177 layers -> 23 partition points).

Both rules reduce to one graph property: a valid partition point is a
position in the topological order where exactly **one** edge crosses from the
prefix to the suffix (a "bridge" of the layer DAG).  :func:`fuse_blocks`
linearises the DAG into the block sequence that the benchmarking and
partitioning stages (bench.py / partition.py) operate on.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Callable, Sequence

import torch


@dataclass(frozen=True)
class TensorSpec:
    """Shape and dtype of a tensor, without its data (the port's
    counterpart of ``jax.ShapeDtypeStruct``)."""

    shape: tuple[int, ...]
    dtype: torch.dtype

    def __post_init__(self):
        object.__setattr__(self, "shape", tuple(int(d) for d in self.shape))

    @property
    def nbytes(self) -> int:
        return int(math.prod(self.shape)) * self.dtype.itemsize


def _nbytes(spec: TensorSpec) -> int:
    return spec.nbytes


@dataclass
class LayerNode:
    """One layer of a DNN.

    ``apply`` consumes the outputs of the node's predecessors (a single array
    for unary layers, a list for merge layers such as residual-add or
    concat).  ``flops`` is an optional analytic estimate used by the
    analytic benchmark provider; the timing and compiled-cost providers do
    not need it.
    """

    name: str
    kind: str
    apply: Callable[..., Any] | None = None
    flops: float = 0.0
    param_bytes: int = 0
    # Optional: compute FLOPs from (input specs, output spec) at trace time
    # (layers whose cost depends on activation shapes, e.g. convs).
    flops_fn: Callable[..., float] | None = None
    # Optional autotuner hooks (kernels/substrate.py): ``kernel`` names the
    # substrate kernel this layer wraps, ``kernel_factory(params)`` rebuilds
    # ``apply`` for a candidate block-size dict, ``kernel_params`` holds the
    # current (default or tuned) block sizes, and ``kernel_defaults`` is the
    # immutable construction-time baseline sweeps are compared against.
    kernel: str | None = None
    kernel_factory: Callable[[dict], Callable[..., Any]] | None = None
    kernel_params: dict = field(default_factory=dict)
    kernel_defaults: dict = field(default_factory=dict)
    # Non-shape configuration baked into ``kernel_factory`` closures
    # (causal/window/softcap, cache sizes, ...) — part of the sweep cache
    # key, so nodes with equal input shapes but different behaviour are
    # tuned separately.
    kernel_options: dict = field(default_factory=dict)
    # Filled in by LayerGraph.trace():
    out_spec: TensorSpec | None = None

    @property
    def output_bytes(self) -> int:
        if self.out_spec is None:
            raise ValueError(f"layer {self.name!r} has not been traced")
        return _nbytes(self.out_spec)


class LayerGraph:
    """A single-input single-output DAG of :class:`LayerNode` s.

    Nodes must be added in a valid topological order (standard for layer
    definitions).  Edges point from producer to consumer.
    """

    def __init__(self, name: str):
        self.name = name
        self.nodes: list[LayerNode] = []
        self.preds: list[list[int]] = []
        self.input_spec: TensorSpec | None = None

    # -- construction -----------------------------------------------------
    def add(self, node: LayerNode, preds: Sequence[int] = ()) -> int:
        idx = len(self.nodes)
        for p in preds:
            if not 0 <= p < idx:
                raise ValueError(
                    f"node {node.name!r}: predecessor {p} is not an earlier node"
                )
        self.nodes.append(node)
        self.preds.append(list(preds))
        return idx

    def input(self, spec: TensorSpec, name: str = "input") -> int:
        if self.nodes:
            raise ValueError("input() must create the first node")
        self.input_spec = spec
        node = LayerNode(name=name, kind="input", apply=None)
        node.out_spec = spec
        return self.add(node)

    # -- basic properties --------------------------------------------------
    @property
    def n_layers(self) -> int:
        return len(self.nodes)

    @property
    def succs(self) -> list[list[int]]:
        out: list[list[int]] = [[] for _ in self.nodes]
        for i, ps in enumerate(self.preds):
            for p in ps:
                out[p].append(i)
        return out

    def validate(self) -> None:
        """Run the graph IR checker (repro_torch.analysis.graph_lint) and
        raise :class:`~repro_torch.analysis.graph_lint.GraphLintError` — a
        ``ValueError`` carrying every named-node diagnostic, not just the
        first — when the graph is malformed."""
        from ..analysis.diagnostics import errors
        from ..analysis.graph_lint import GraphLintError, lint_graph

        bad = errors(lint_graph(self))
        if bad:
            raise GraphLintError(f"graph {self.name!r} is malformed", bad)

    # -- shape tracing -----------------------------------------------------
    def trace(self) -> None:
        """Fill every node's ``out_spec`` by running the graph on ``meta``
        tensors (shapes and dtypes only: no FLOPs, no allocation)."""
        self.validate()
        spec = self.input_spec
        vals: list[Any] = [torch.empty(spec.shape, dtype=spec.dtype,
                                       device="meta")]
        for i in range(1, len(self.nodes)):
            ins = [vals[p] for p in self.preds[i]]
            fn = self.nodes[i].apply
            if fn is None:
                raise ValueError(f"node {self.nodes[i].name!r} has no apply")
            vals.append(fn(*ins))
        for node, o in zip(self.nodes[1:], vals[1:]):
            node.out_spec = TensorSpec(tuple(o.shape), o.dtype)
        for i, node in enumerate(self.nodes):
            if node.flops_fn is not None:
                ins = [self.nodes[p].out_spec for p in self.preds[i]]
                node.flops = float(node.flops_fn(ins, node.out_spec))

    # -- partition points --------------------------------------------------
    def crossing_counts(self) -> list[int]:
        """``counts[i]`` = number of **distinct producers** with edges from
        nodes ``0..i`` to nodes ``i+1..``.

        A cut is valid when exactly one tensor crosses it — i.e. all crossing
        edges emanate from one producer.  A fork (a->b1, a->b2) therefore does
        not invalidate the cut after ``a``: both edges carry ``a``'s output.
        A residual skip (a->add bypassing b) keeps two producers open between
        ``b`` and ``add``, so cuts inside the residual region are invalid —
        exactly the paper's branch-fusion rule.
        """
        succs = self.succs
        last_use = [max(s) if s else i for i, s in enumerate(succs)]
        counts = []
        open_prod = 0
        closing_at: dict[int, int] = {}
        for i in range(len(self.nodes)):
            if last_use[i] > i:
                open_prod += 1
                closing_at[last_use[i]] = closing_at.get(last_use[i], 0) + 1
            open_prod -= closing_at.pop(i, 0)
            counts.append(open_prod)
        return counts

    def partition_points(self) -> list[int]:
        """Valid partition points: positions ``i`` such that cutting between
        node ``i`` and node ``i+1`` transfers exactly one tensor.

        Position 0 (right after the input layer) is excluded per the paper's
        ``N-2`` rule, as is the position after the final layer.  With a
        single open producer at position ``i``, that producer is necessarily
        node ``i`` itself (node ``i`` must feed someone later), so the block
        ending at ``i`` owns the crossing tensor.
        """
        counts = self.crossing_counts()
        return [i for i in range(1, len(self.nodes) - 1) if counts[i] == 1]


@dataclass
class Block:
    """A fused unit: maximal run of layers between consecutive partition
    points.  This is the entity Scission benchmarks and assigns to
    resources."""

    index: int
    node_ids: list[int]
    graph: LayerGraph = field(repr=False)

    @property
    def name(self) -> str:
        ns = [self.graph.nodes[i].name for i in (self.node_ids[0], self.node_ids[-1])]
        return ns[0] if len(self.node_ids) == 1 else f"{ns[0]}..{ns[1]}"

    @property
    def kinds(self) -> list[str]:
        return [self.graph.nodes[i].kind for i in self.node_ids]

    @property
    def flops(self) -> float:
        return sum(self.graph.nodes[i].flops for i in self.node_ids)

    @property
    def param_bytes(self) -> int:
        return sum(self.graph.nodes[i].param_bytes for i in self.node_ids)

    @property
    def output_bytes(self) -> int:
        """Bytes crossing the cut after this block (the paper's layer
        'output data size')."""
        return self.graph.nodes[self.node_ids[-1]].output_bytes

    @property
    def entry_nodes(self) -> list[int]:
        """External producer node ids feeding this block, in first-use
        order.  Chain blocks have exactly one (the previous cut's single
        crossing tensor); a DAG join block fused by :func:`fuse_block_dag`
        has one per incoming branch.  The input block has none."""
        ids = set(self.node_ids)
        ext: list[int] = []
        for i in self.node_ids:
            for p in self.graph.preds[i]:
                if p not in ids and p not in ext:
                    ext.append(p)
        return ext

    @property
    def in_specs(self) -> list[TensorSpec]:
        """One input spec per entry tensor (the multi-edge generalisation
        of :attr:`in_spec`; equal to ``[in_spec]`` for chain blocks)."""
        ext = self.entry_nodes
        if not ext:
            first = self.node_ids[0]
            return [self.graph.nodes[first].out_spec]  # the input block
        return [self.graph.nodes[p].out_spec for p in ext]

    @property
    def in_spec(self) -> TensorSpec:
        first = self.node_ids[0]
        preds = self.graph.preds[first]
        ext = self.entry_nodes
        if len(ext) > 1:
            raise ValueError(
                f"block {self.index} ({self.name}) has {len(ext)} entry "
                "tensors; use in_specs for DAG blocks")
        # By construction a chain block's first node has exactly one
        # predecessor (the single crossing edge of the preceding cut)
        # unless it is the input node.
        src = preds[0] if preds else first
        return self.graph.nodes[src].out_spec  # type: ignore[return-value]

    @property
    def out_spec(self) -> TensorSpec:
        return self.graph.nodes[self.node_ids[-1]].out_spec  # type: ignore[return-value]

    def make_callable(self) -> Callable[..., Any]:
        """Build the standalone sub-model for this block (paper Step 2: each
        sub-model gets an input layer fed with the previous block's
        output).  The callable takes one argument per entry tensor, in
        :attr:`entry_nodes` order — a single argument for every chain
        block, so existing single-tensor call sites are unchanged."""
        g = self.graph
        ids = self.node_ids
        id_set = set(ids)
        entries = self.entry_nodes

        def apply(*xs):
            want = max(1, len(entries))
            if len(xs) != want:
                raise ValueError(
                    f"block {self.index} ({self.name}) takes {want} input "
                    f"tensor(s), got {len(xs)}")
            vals: dict[int, Any] = dict(zip(entries, xs))
            for i in ids:
                if not g.preds[i]:            # the input node itself
                    vals[i] = xs[0]
                    continue
                ins = []
                for p in g.preds[i]:
                    if p not in id_set and p not in vals:
                        raise ValueError(
                            f"block {self.index} node {g.nodes[i].name!r} reads "
                            f"from outside the block (node {p}) — invalid cut")
                    ins.append(vals[p])
                vals[i] = g.nodes[i].apply(*ins)
            return vals[ids[-1]]

        return apply


@dataclass
class SPNode:
    """One node of the series-parallel decomposition tree.

    * ``leaf`` — a single :class:`Block` (``block`` is its index).
    * ``series`` — ``children`` executed in order; each child's entry tensor
      is the previous child's exit tensor.
    * ``parallel`` — ``children`` are the branch subtrees (each a ``series``
      node), all fed by the preceding sibling's exit tensor (the fork).
      ``direct=True`` records a fork→join edge alongside the branches
      (the residual-skip case).  The join block is the *next* leaf in the
      enclosing series — a parallel node never owns its join, so nested
      forks that share a join stay representable.
    """

    kind: str                     # 'leaf' | 'series' | 'parallel'
    block: int = -1               # leaf only
    children: list["SPNode"] = field(default_factory=list)
    direct: bool = False          # parallel only: fork→join edge exists

    def leaves(self) -> list[int]:
        if self.kind == "leaf":
            return [self.block]
        return [b for c in self.children for b in c.leaves()]


class BlockDag(list):
    """A block sequence plus its edge structure and SP decomposition tree.

    Subclasses ``list`` so every chain-era consumer (indexing, ``len``,
    iteration over :class:`Block` s) keeps working unchanged; DAG-aware
    consumers read ``preds`` (block-level edges), ``tree`` (the
    :class:`SPNode` decomposition) and the fallback bookkeeping:
    ``parallel_regions`` (node-id groups that chain fusing would collapse)
    and ``collapsed`` (node-id groups that are not series-parallel and were
    linearised into a single block — the diagnosed fallback).
    """

    def __init__(self, blocks: Sequence[Block], preds: list[list[int]] | None = None,
                 tree: SPNode | None = None,
                 parallel_regions: Sequence[Sequence[int]] = (),
                 collapsed: Sequence[Sequence[int]] = ()):
        super().__init__(blocks)
        n = len(self)
        self.preds: list[list[int]] = (
            [list(ps) for ps in preds] if preds is not None
            else [[] if i == 0 else [i - 1] for i in range(n)])
        self.tree: SPNode = tree if tree is not None else SPNode(
            "series", children=[SPNode("leaf", block=i) for i in range(n)])
        self.parallel_regions = [list(r) for r in parallel_regions]
        self.collapsed = [list(r) for r in collapsed]

    @property
    def succs(self) -> list[list[int]]:
        out: list[list[int]] = [[] for _ in self]
        for i, ps in enumerate(self.preds):
            for p in ps:
                out[p].append(i)
        return out

    @property
    def is_chain(self) -> bool:
        return all(ps == ([] if i == 0 else [i - 1])
                   for i, ps in enumerate(self.preds))

    def edges(self) -> list[tuple[int, int]]:
        """Block-level edges ``(producer, consumer)`` with producer < consumer."""
        return [(p, i) for i, ps in enumerate(self.preds) for p in ps]


def fuse_blocks(graph: LayerGraph) -> BlockDag:
    """Linearise ``graph`` into its block sequence (Scission Step 1-2).

    Cuts are the valid partition points; each maximal segment between
    consecutive cuts becomes one :class:`Block`.  The number of *inter-block*
    positions, ``len(blocks) - 1``, equals the paper's "partition points"
    column in Table I.

    Returns a :class:`BlockDag` in *chain* form (``preds`` is the linear
    chain) — parallel regions are fused whole, exactly as in the paper.
    Use :func:`fuse_block_dag` to keep branch structure instead.
    """
    if not graph.nodes or graph.nodes[-1].out_spec is None:
        graph.trace()               # trace() validates first
    else:
        graph.validate()            # already traced: still well-formedness-check
    points = graph.partition_points()
    blocks: list[Block] = []
    start = 0
    for bi, p in enumerate([*points, len(graph.nodes) - 1]):
        blocks.append(Block(index=bi, node_ids=list(range(start, p + 1)), graph=graph))
        start = p + 1
    return BlockDag(blocks)


# ---------------------------------------------------------------------------
# Series-parallel decomposition (the DAG-general fusing pass)
# ---------------------------------------------------------------------------

def _undirected_components(nodes: Sequence[int], preds: list[list[int]],
                           succs: list[list[int]]) -> list[list[int]]:
    """Connected components of the induced subgraph, each in topo order,
    ordered by first node."""
    member = set(nodes)
    seen: set[int] = set()
    comps: list[list[int]] = []
    for n in nodes:
        if n in seen:
            continue
        stack, comp = [n], []
        while stack:
            u = stack.pop()
            if u in seen or u not in member:
                continue
            seen.add(u)
            comp.append(u)
            stack.extend(p for p in preds[u] if p in member)
            stack.extend(s for s in succs[u] if s in member)
        comps.append(sorted(comp))
    return comps


def _sp_parts(preds: list[list[int]], succs: list[list[int]],
              nodes: list[int], entry: int | None, top: bool,
              parallel_regions: list[list[int]],
              collapsed: list[list[int]]) -> list[tuple]:
    """Decompose a two-terminal region into series parts.

    ``nodes`` is the region in topo order; ``entry`` is the graph node whose
    output tensor feeds the region (``None`` only for the whole graph, whose
    first node is the input layer).  Each returned part is either
    ``('leaf', [node_ids])`` or ``('par', [branch_parts, ...], direct)``
    where every ``branch_parts`` is itself a part list and ``direct`` marks
    a fork→join edge.  A ``'par'`` part is always followed by the leaf
    holding its join node.

    Cuts are positions where exactly one producer (counting the entry
    tensor) stays open — the same crossing-count rule as
    :meth:`LayerGraph.partition_points`, applied region-locally, with nodes
    feeding *outside* the region held open to the region's end.  A region
    that cannot be split series-wise is examined as a fork-join: the
    undirected components of its interior become parallel branches when
    each has a single exit; otherwise the region is recorded in
    ``collapsed`` and fused into one block (the non-SP fallback).
    """
    member = set(nodes)
    m = len(nodes)
    pos = {n: k for k, n in enumerate(nodes)}
    open_until = list(range(m))
    entry_until = -1
    for k, nd in enumerate(nodes):
        for p in preds[nd]:
            if p in pos:
                if open_until[pos[p]] < k:
                    open_until[pos[p]] = k
            else:
                entry_until = k
        if any(s not in member for s in succs[nd]):
            open_until[k] = m       # feeds the region's consumer: open to end
    lo = 1 if top else 0            # the paper's N-2 rule, top level only
    cuts = [k for k in range(lo, m - 1)
            if sum(1 for j in range(k + 1) if open_until[j] > k)
            + (1 if entry_until > k else 0) == 1]

    parts: list[tuple] = []
    prev_exit = entry
    start = 0
    for cut in [*cuts, m - 1]:
        seg = nodes[start:cut + 1]
        start = cut + 1
        if len(seg) == 1:
            parts.append(("leaf", seg))
        else:
            parts.extend(_fork_join(preds, succs, seg, prev_exit,
                                    parallel_regions, collapsed))
        prev_exit = seg[-1]
    return parts


def _fork_join(preds: list[list[int]], succs: list[list[int]],
               seg: list[int], entry: int | None,
               parallel_regions: list[list[int]],
               collapsed: list[list[int]]) -> list[tuple]:
    """Decompose one un-splittable multi-node segment as fork → branches →
    join, or fall back to a single fused leaf (recorded in ``collapsed``)."""
    if entry is None:
        # Whole-graph head segment: the input node is the fork.  Peel it,
        # decompose the rest, and re-merge it into a leading leaf so pure
        # chains fuse exactly as fuse_blocks does.
        head, rest = seg[0], seg[1:]
        sub = _sp_parts(preds, succs, rest, head, False,
                        parallel_regions, collapsed)
        if sub and sub[0][0] == "leaf":
            sub[0] = ("leaf", [head, *sub[0][1]])
        else:
            sub.insert(0, ("leaf", [head]))
        return sub

    join, interior = seg[-1], seg[:-1]
    comps = _undirected_components(interior, preds, succs)
    direct = entry in preds[join]
    ok = len(comps) >= 2 or direct
    for comp in comps:
        cs = set(comp)
        exits = [n for n in comp if any(s not in cs for s in succs[n])]
        if exits != [comp[-1]]:
            ok = False              # multi-exit branch: one block per branch
            break                   # would need several output tensors
    if not ok:
        collapsed.append(list(seg))
        return [("leaf", list(seg))]
    parallel_regions.append([n for c in comps for n in c])
    branches = [_sp_parts(preds, succs, comp, entry, False,
                          parallel_regions, collapsed)
                for comp in comps]
    return [("par", branches, direct), ("leaf", [join])]


def _build_sp(parts: list[tuple], graph: LayerGraph, blocks: list[Block],
              bpreds: list[list[int]], owner: dict[int, int]) -> list[SPNode]:
    children: list[SPNode] = []
    for part in parts:
        if part[0] == "leaf":
            ids = part[1]
            bid = len(blocks)
            blocks.append(Block(index=bid, node_ids=list(ids), graph=graph))
            id_set = set(ids)
            ext: list[int] = []
            for i in ids:
                for p in graph.preds[i]:
                    if p not in id_set and owner[p] not in ext:
                        ext.append(owner[p])
            bpreds.append(ext)
            for i in ids:
                owner[i] = bid
            children.append(SPNode("leaf", block=bid))
        else:                        # ('par', branches, direct)
            branches = [SPNode("series",
                               children=_build_sp(bp, graph, blocks, bpreds, owner))
                        for bp in part[1]]
            children.append(SPNode("parallel", children=branches,
                                   direct=part[2]))
    return children


def fuse_block_dag(graph: LayerGraph) -> BlockDag:
    """Fuse ``graph`` into a block **DAG** via series-parallel decomposition.

    Where :func:`fuse_blocks` collapses every parallel region into one
    block, this pass keeps the branch structure: the fork, each branch's
    blocks, and the join become separate blocks connected by multi-tensor
    block edges, and the returned :class:`BlockDag.tree` records the
    series/parallel recursion the partitioning DP runs over.  On a linear
    graph the result is block-for-block identical to :func:`fuse_blocks`
    (chain = trivial decomposition).  Regions that are not series-parallel
    (or whose branches need more than one output tensor) are fused into a
    single block and listed in ``BlockDag.collapsed`` — the diagnosed
    linearization fallback surfaced by ``scission-lint`` as SCN309.
    """
    if not graph.nodes or graph.nodes[-1].out_spec is None:
        graph.trace()
    else:
        graph.validate()
    parallel_regions: list[list[int]] = []
    collapsed: list[list[int]] = []
    parts = _sp_parts(graph.preds, graph.succs, list(range(len(graph.nodes))),
                      None, True, parallel_regions, collapsed)
    blocks: list[Block] = []
    bpreds: list[list[int]] = []
    children = _build_sp(parts, graph, blocks, bpreds, {})
    return BlockDag(blocks, preds=bpreds,
                    tree=SPNode("series", children=children),
                    parallel_regions=parallel_regions, collapsed=collapsed)


def sp_summary(graph: LayerGraph) -> tuple[list[list[int]], list[list[int]]]:
    """Topology-only SP analysis: ``(parallel_regions, collapsed_regions)``
    as node-id groups, without tracing the graph.  Used by the graph
    linter (SCN309/SCN310)."""
    parallel_regions: list[list[int]] = []
    collapsed: list[list[int]] = []
    if len(graph.nodes) > 1:
        _sp_parts(graph.preds, graph.succs, list(range(len(graph.nodes))),
                  None, True, parallel_regions, collapsed)
    return parallel_regions, collapsed


# ---------------------------------------------------------------------------
# Convenience constructors for linear graphs (the common case for tests and
# the LM-family architectures, whose residual stream is linear at block level)
# ---------------------------------------------------------------------------

def linear_graph(name: str, input_spec: TensorSpec,
                 layers: Sequence[LayerNode]) -> LayerGraph:
    g = LayerGraph(name)
    prev = g.input(input_spec)
    for node in layers:
        prev = g.add(node, preds=[prev])
    g.trace()
    return g
