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
from ..core.graph import LayerGraph, fuse_blocks
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
