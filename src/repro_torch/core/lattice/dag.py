"""DAG cost semantics: pricing resource *assignments* over a block DAG.

The chain cost model prices a sequence of segments; on a block DAG the
unit of decision is an **assignment** — one resource per block, monotone
along edges (a consumer runs on its producer's resource or a strictly
later tier).  The multi-edge generalisation of the paper's cut costs:

* a cut crossed by ``k`` tensors transfers the **sum of the edge bytes**
  (each crossing edge ``u→v`` with ``assignment[u] != assignment[v]`` is
  priced independently: ``comm(r_u, r_v, out_bytes[u])``);
* **latency** composes by critical path — parallel branches placed on
  distinct resources overlap, so
  ``finish(v) = max_u(finish(u) + comm(u→v)) + time(v)``;
* **throughput** keeps the existing bottleneck math: a resource's stage
  period is its *total* assigned compute time over ``replicas × batch``,
  and every crossing edge (plus the input hop) contributes a hop period —
  the steady-state rate is 1 / max over all periods.

On a chain every block has one predecessor, the critical path degenerates
to the plain sum, and these formulas reduce exactly to
:meth:`CostModel.evaluate`.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .chain import CostModel, PartitionConfig, Segment


@dataclass
class DagPartitionConfig(PartitionConfig):
    """A ranked DAG configuration: an assignment-based operating point.

    ``assignment[i]`` is the resource hosting block ``i``.  ``segments``
    holds the maximal index-contiguous runs of equal resource (so chain
    consumers can still render/describe the config), but the pipelined
    stage model is **per resource**: ``stage_compute_s[k]`` is the total
    compute time of the k-th pipeline resource (tier order), ``replicas``
    aligns with it, and ``stage_comm_s`` holds one per-batch transfer time
    per crossing edge.  ``stage_periods_s`` therefore does not interleave
    compute and comm — it is the flat set of effective periods the
    bottleneck is the max of.
    """

    assignment: tuple[str, ...] = ()
    # resources in pipeline (tier) order, aligned with stage_compute_s /
    # replicas — a resource may host blocks from several segments
    pipeline: tuple[str, ...] = ()
    # crossing block-edges (u, v), aligned with stage_comm_s
    cut_edges: tuple[tuple[int, int], ...] = ()

    @property
    def resources(self) -> tuple[str, ...]:
        return self.pipeline

    @property
    def stage_periods_s(self) -> tuple[float, ...]:
        b = max(1, self.batch_size)
        periods: list[float] = []
        if self.input_comm_s > 0.0:
            periods.append(self.input_comm_s / b)
        for k, t in enumerate(self.stage_compute_s):
            periods.append(t / (self.replica_count(k) * b))
        periods.extend(h / b for h in self.stage_comm_s)
        return tuple(periods)

    def describe(self) -> str:
        groups: dict[str, list[int]] = {}
        for i, r in enumerate(self.assignment):
            groups.setdefault(r, []).append(i)
        parts = [f"{r}: {','.join(map(str, groups[r]))}" for r in self.pipeline]
        op = ""
        if self.batch_size != 1:
            op += f" batch={self.batch_size}"
        if any(r != 1 for r in self.replicas):
            op += " reps=" + "x".join(str(self.replica_count(k))
                                      for k in range(len(self.pipeline)))
        return (f"[{self.model}] " + " | ".join(parts)
                + f"  latency={self.latency_s * 1e3:.1f}ms"
                + f" thpt={self.throughput_rps:.1f}rps"
                + f" transfer={self.transfer_bytes / 1e6:.3f}MB" + op)


@dataclass
class DagCostModel(CostModel):
    """:class:`CostModel` plus the block-edge structure of a
    :class:`~repro_torch.core.graph.BlockDag`.

    ``block_preds[i]`` lists the producer blocks of block ``i`` (empty =
    chain predecessor semantics are *not* implied — an empty
    ``block_preds`` means "this is a chain" and the model behaves exactly
    like its base class).  ``tree`` optionally carries the SP
    decomposition (:class:`~repro_torch.core.graph.SPNode`) the
    :class:`~repro_torch.core.lattice.sp.SPSolver` runs over.
    """

    block_preds: list = field(default_factory=list)
    tree: object = None          # SPNode | None (kept untyped: graph import)

    def __post_init__(self):
        super().__post_init__()
        if self.block_preds and len(self.block_preds) != self.n_blocks:
            raise ValueError(
                f"block_preds has {len(self.block_preds)} entries for "
                f"{self.n_blocks} blocks")
        if not self.block_preds:
            self.block_preds = [[] if i == 0 else [i - 1]
                                for i in range(self.n_blocks)]

    @property
    def is_chain(self) -> bool:
        return all(ps == ([] if i == 0 else [i - 1])
                   for i, ps in enumerate(self.block_preds))

    def edges(self) -> list[tuple[int, int]]:
        return [(u, v) for v, ps in enumerate(self.block_preds) for u in ps]

    def _tier(self, resource: str) -> int:
        for r in self.resources:
            if r.name == resource:
                return r.order
        raise KeyError(resource)

    def evaluate_assignment(self, assignment) -> DagPartitionConfig:
        """Price one complete assignment (resource name per block).

        This is the single cost definition shared by the exhaustive DAG
        oracle and the SP solver — both produce configs through it, which
        is what makes label-for-label agreement meaningful.
        """
        assignment = tuple(assignment)
        B = self.n_blocks
        if len(assignment) != B:
            raise ValueError(
                f"assignment names {len(assignment)} blocks, model has {B}")
        r0 = assignment[0]
        input_comm = 0.0
        xfer = 0.0
        if r0 != self.source:
            input_comm = self.comm(self.source, r0, self.batch_input_bytes)
            xfer += self.batch_input_bytes
        finish = [0.0] * B
        compute: dict[str, float] = {}
        comm_total = 0.0
        stage_comm: list[float] = []
        cut_edges: list[tuple[int, int]] = []
        for v in range(B):
            rv = assignment[v]
            t = self.segment_time(rv, v, v)
            compute[rv] = compute.get(rv, 0.0) + t
            arrive = input_comm if v == 0 else 0.0
            for u in self.block_preds[v]:
                c = 0.0
                if assignment[u] != rv:
                    nb = float(self.out_bytes[u])
                    c = self.comm(assignment[u], rv, nb)
                    comm_total += c
                    xfer += nb
                    stage_comm.append(c)
                    cut_edges.append((u, v))
                arrive = max(arrive, finish[u] + c)
            finish[v] = arrive + t

        # index-contiguous runs of equal resource, for chain-style display
        segs: list[Segment] = []
        for v, r in enumerate(assignment):
            if segs and segs[-1].resource == r:
                segs[-1] = Segment(r, segs[-1].start, v)
            else:
                segs.append(Segment(r, v, v))
        pipeline = sorted(dict.fromkeys(assignment),
                          key=lambda r: (self._tier(r), assignment.index(r)))
        return DagPartitionConfig(
            model=self.db.model, segments=tuple(segs),
            latency_s=finish[B - 1], compute_s=compute, comm_s=comm_total,
            transfer_bytes=xfer, input_comm_s=input_comm,
            stage_compute_s=tuple(compute[r] for r in pipeline),
            stage_comm_s=tuple(stage_comm),
            batch_size=self.batch_size,
            replicas=tuple(self.replicas_for(r) for r in pipeline),
            assignment=assignment, pipeline=tuple(pipeline),
            cut_edges=tuple(cut_edges))
