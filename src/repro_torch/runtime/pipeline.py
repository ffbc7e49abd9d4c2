"""Partition-driven pipeline executor.

Executes a Scission :class:`PartitionConfig` — each segment's blocks run as
one stage on its assigned resource, activations crossing between stages
exactly at the chosen cut points.  On a real deployment each stage lives on
a different machine; here every stage runs on one device and the
inter-stage handoff goes through host memory (the same path a WAN hop would
take), with the simulated link cost accounted by the latency model.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable

import torch

from .._device import resolve_device, synchronize
from ..core.graph import LayerGraph, fuse_block_dag, fuse_blocks
from ..core.network import NetworkModel
from ..core.partition import PartitionConfig


@dataclass
class Stage:
    resource: str
    start: int
    end: int
    fn: Callable[[Any], Any]


@dataclass
class StageTiming:
    resource: str
    compute_s: float
    comm_in_s: float
    bytes_in: int


class PipelineExecutor:
    """Build-once, run-many executor for one (graph, partition) on
    ``device``."""

    def __init__(self, graph: LayerGraph, config: PartitionConfig,
                 network: NetworkModel | None = None, source: str = "device",
                 device: str | torch.device = "cuda"):
        self.graph = graph
        self.config = config
        self.network = network
        self.source = source
        self.device = resolve_device(device)
        blocks = fuse_blocks(graph)
        self.stages: list[Stage] = []
        for seg in config.segments:
            fns = [blocks[i].make_callable()
                   for i in range(seg.start, seg.end + 1)]

            def stage_fn(x, fns=tuple(fns)):
                for f in fns:
                    x = f(x)
                return x

            self.stages.append(Stage(seg.resource, seg.start, seg.end,
                                     stage_fn))

    def run(self, x, collect_timing: bool = False):
        """Run input through all stages.  Returns (y, [StageTiming])."""
        timings: list[StageTiming] = []
        prev_loc = self.source
        x = torch.as_tensor(x)
        for st in self.stages:
            nbytes = x.numel() * x.element_size()
            comm = (self.network.comm_time(prev_loc, st.resource, nbytes)
                    if self.network and prev_loc != st.resource else 0.0)
            # host round-trip at the tier boundary (the WAN hop's data path)
            x = x.cpu().to(self.device)
            synchronize(self.device)
            t0 = time.perf_counter()
            y = st.fn(x)
            synchronize(self.device)
            dt = time.perf_counter() - t0
            if collect_timing:
                timings.append(StageTiming(st.resource, dt, comm, nbytes))
            x = y
            prev_loc = st.resource
        return x, timings

    def simulated_latency(self, timings: list[StageTiming],
                          speed_factors: dict[str, float]) -> float:
        """End-to-end latency under the emulated tier speeds + links."""
        total = 0.0
        for t in timings:
            total += t.compute_s * speed_factors.get(t.resource, 1.0)
            total += t.comm_in_s
        return total


@dataclass
class BlockTiming:
    """Per-block measurement of one :class:`DagPipelineExecutor.run`.

    ``comm_in_s`` carries one entry per incoming block edge (entry order;
    block 0's single entry is the source input hop) — zero for edges whose
    endpoints share a resource."""

    block: int
    resource: str
    compute_s: float
    comm_in_s: tuple[float, ...]
    bytes_in: int


class DagPipelineExecutor:
    """Build-once, run-many executor for one (graph, DAG partition) on
    ``device``.

    The DAG counterpart of :class:`PipelineExecutor`: the graph is fused
    with :func:`fuse_block_dag` (parallel regions survive as block-level
    branches), and execution walks blocks in topological order keeping
    every produced activation until its consumers have run.  Blocks on
    *parallel branches* are issued on the one stream without a synchronise
    between them, as the reference dispatches them without
    ``block_until_ready``; the join block's callable takes one argument per
    incoming branch.  Activations crossing between resources take the host
    round-trip (the WAN hop's data path), one per crossing edge, with the
    link cost accounted by the latency model.

    ``config`` may be a :class:`DagPartitionConfig` (``assignment`` names a
    resource per block) or any chain :class:`PartitionConfig` whose
    segments cover the fused block count — the chain form of the same
    contract.
    """

    def __init__(self, graph: LayerGraph, config: PartitionConfig,
                 network: NetworkModel | None = None, source: str = "device",
                 device: str | torch.device = "cuda"):
        self.graph = graph
        self.config = config
        self.network = network
        self.source = source
        self.device = resolve_device(device)
        dag = fuse_block_dag(graph)
        assignment = tuple(getattr(config, "assignment", ()))
        if not assignment:
            assignment = tuple(
                seg.resource for seg in config.segments
                for _ in range(seg.start, seg.end + 1))
        if len(assignment) != len(dag):
            raise ValueError(
                f"partition names {len(assignment)} blocks but the graph "
                f"fuses into {len(dag)} DAG blocks")
        self.dag = dag
        self.assignment = assignment
        self.fns = [b.make_callable() for b in dag]
        # producing block per entry tensor, in each block's entry order
        owner: dict[int, int] = {}
        for blk in dag:
            for n in blk.node_ids:
                owner[n] = blk.index
        self.entry_blocks: list[list[int]] = []
        for blk in dag:
            ebs = []
            for e in blk.entry_nodes:
                pb = owner[e]
                if dag[pb].node_ids[-1] != e:
                    raise ValueError(
                        f"block {blk.index} consumes node {e}, which is not "
                        f"block {pb}'s output tensor — invalid block DAG")
                ebs.append(pb)
            self.entry_blocks.append(ebs)

    def _hop(self, x) -> torch.Tensor:
        """The host round-trip at a tier boundary."""
        return torch.as_tensor(x).cpu().to(self.device)

    def run(self, x, collect_timing: bool = False):
        """Run input through the block DAG.  Returns (y, [BlockTiming]).

        Without timing collection, blocks are issued back to back (parallel
        branches queue on the stream without a synchronise) and only the
        final output is waited on; with it, each block is timed
        individually.
        """
        timings: list[BlockTiming] = []
        outs: list[Any] = [None] * len(self.dag)
        for b, blk in enumerate(self.dag):
            comms: list[float] = []
            bytes_in = 0
            if not self.entry_blocks[b]:
                xi = self._hop(x)
                nbytes = xi.numel() * xi.element_size()
                bytes_in = nbytes
                if self.network and self.assignment[b] != self.source:
                    comms.append(self.network.comm_time(
                        self.source, self.assignment[b], nbytes))
                xs = [xi]
            else:
                xs = []
                for pb in self.entry_blocks[b]:
                    xp = outs[pb]
                    if self.assignment[pb] != self.assignment[b]:
                        xp = self._hop(xp)
                        nbytes = xp.numel() * xp.element_size()
                        bytes_in += nbytes
                        if self.network:
                            comms.append(self.network.comm_time(
                                self.assignment[pb], self.assignment[b],
                                nbytes))
                    xs.append(xp)
            if collect_timing:
                synchronize(self.device)
                t0 = time.perf_counter()
                y = self.fns[b](*xs)
                synchronize(self.device)
                timings.append(BlockTiming(
                    b, self.assignment[b], time.perf_counter() - t0,
                    tuple(comms), bytes_in))
            else:
                y = self.fns[b](*xs)
            outs[b] = y
        y = outs[len(self.dag) - 1]
        synchronize(self.device)
        return y, timings

    def simulated_latency(self, timings: list[BlockTiming],
                          speed_factors: dict[str, float]) -> float:
        """Critical-path latency under the emulated tier speeds + links:
        ``finish(b) = max over incoming edges(finish(pred) + link) +
        compute * speed`` — parallel branches overlap, exactly the DAG cost
        model's latency composition."""
        finish: dict[int, float] = {}
        for t in timings:
            arrive = 0.0
            ebs = self.entry_blocks[t.block]
            if not ebs:
                arrive = sum(t.comm_in_s)          # the source input hop
            else:
                ci = iter(t.comm_in_s)
                for pb in ebs:
                    c = next(ci) if self.assignment[pb] != t.resource else 0.0
                    arrive = max(arrive, finish[pb] + c)
            finish[t.block] = arrive + \
                t.compute_s * speed_factors.get(t.resource, 1.0)
        return finish[max(finish)] if finish else 0.0
