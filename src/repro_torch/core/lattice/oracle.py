"""DAG-aware exhaustive oracle (the validation ground truth for the SP DP).

Enumerates every **tier-monotone assignment**: block 0 may start on any
resource; along every block edge the consumer either stays on the
producer's resource or hands off to a strictly later tier.  On a chain
this is exactly the set of configurations ``enumerate_partitions``
produces (every ordered sub-pipeline × every cut combination); on a DAG
it additionally allows *parallel branches on distinct same-tier
resources* — two edge boxes each running one branch — which is precisely
the placement freedom DAG partitioning exists to exploit.

``dag_search_space`` counts the same set with an early cutoff, giving the
query engine the number it compares against the exhaustive/lattice
crossover (the chain analogue is the ``math.comb`` pipe sum).
"""

from __future__ import annotations

from typing import Iterable, Sequence

from .chain import Constraints
from .dag import DagCostModel, DagPartitionConfig


def _assignment_universe(cost: DagCostModel,
                         constraints: Constraints | None) -> tuple[list[str], dict[str, int]]:
    cons = constraints or Constraints()
    names = [r.name for r in cost.resources if r.name not in cons.exclude]
    order = {r.name: r.order for r in cost.resources}
    return names, order


def _iter_assignments(preds: Sequence[Sequence[int]], names: list[str],
                      order: dict[str, int], cons: Constraints,
                      limit: int | None = None) -> Iterable[tuple[str, ...]]:
    """Depth-first enumeration of tier-monotone assignments (generator).

    ``allowed`` (exclude via the pre-filtered ``names``, pin per block) is
    applied during enumeration; everything else is filtered downstream so
    the enumeration set matches what the query engine caches.

    The per-block candidate lists and tier orders are hoisted out of the
    DFS: ``allowed``/``order`` answers are path-independent, and this
    generator backs ``dag_search_space`` — which the engine runs on every
    query dispatch — so the inner loop touches only precomputed lists.
    """
    B = len(preds)
    cands = [[(r, order[r]) for r in names if cons.allowed(v, r)]
             for v in range(B)]
    chosen: list[str] = []
    chosen_ord: list[int] = []
    count = 0

    def rec(v: int):
        nonlocal count
        if v == B:
            count += 1
            yield tuple(chosen)
            return
        pv = preds[v]
        for r, o in cands[v]:
            ok = True
            for u in pv:
                if chosen[u] != r and o <= chosen_ord[u]:
                    ok = False
                    break
            if not ok:
                continue
            chosen.append(r)
            chosen_ord.append(o)
            yield from rec(v + 1)
            chosen.pop()
            chosen_ord.pop()
            if limit is not None and count > limit:
                return

    yield from rec(0)


def dag_search_space(cost: DagCostModel, constraints: Constraints | None = None,
                     limit: int = 10_000_000) -> int:
    """Number of tier-monotone assignments the exhaustive strategy would
    enumerate (capped at ``limit + 1`` — a return > ``limit`` means "more
    than the cap", which is all the crossover dispatch needs)."""
    names, order = _assignment_universe(cost, constraints)
    cons = constraints or Constraints()
    n = 0
    for _ in _iter_assignments(cost.block_preds, names, order, cons, limit):
        n += 1
        if n > limit:
            break
    return n


def enumerate_dag_partitions(cost: DagCostModel,
                             constraints: Constraints | None = None,
                             max_configs: int = 2_000_000
                             ) -> list[DagPartitionConfig]:
    """Every tier-monotone assignment, priced.  Exact but exponential —
    the :class:`~repro_torch.core.lattice.sp.SPSolver` is the scalable path."""
    names, order = _assignment_universe(cost, constraints)
    cons = constraints or Constraints()
    configs: list[DagPartitionConfig] = []
    for a in _iter_assignments(cost.block_preds, names, order, cons):
        configs.append(cost.evaluate_assignment(a))
        if len(configs) > max_configs:
            raise RuntimeError(
                f"exhaustive DAG enumeration exceeded {max_configs} configs; "
                "use SPSolver")
    return configs


def dag_config_satisfies(cost: DagCostModel, cfg: DagPartitionConfig,
                         cons: Constraints) -> bool:
    """Whole-config constraint check for DAG assignments — the DAG analogue
    of the engine's chain ``_config_satisfies`` + ``path_feasible``."""
    used = set(cfg.assignment)
    if any(r not in used for r in cons.must_use):
        return False
    if used & cons.exclude:
        return False
    for blk, res in cons.pin.items():
        if blk < len(cfg.assignment) and cfg.assignment[blk] != res:
            return False
    if cfg.assignment and cfg.assignment[0] != cost.source:
        if not cons.transition_allowed(cost.source, cfg.assignment[0],
                                       cost.batch_input_bytes):
            return False
    for u, v in cfg.cut_edges:
        if not cons.transition_allowed(cfg.assignment[u], cfg.assignment[v],
                                       float(cost.out_bytes[u])):
            return False
    for res, tmax in cons.max_resource_time.items():
        if cfg.compute_s.get(res, 0.0) > tmax:
            return False
    for res, nmin in cons.min_blocks_on.items():
        if sum(1 for r in cfg.assignment if r == res) < nmin:
            return False
    return True
