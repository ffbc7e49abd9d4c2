"""Partitioning engines: exact DPs over block chains and block DAGs.

The package splits the former ``core/partition.py`` monolith into

* :mod:`~repro_torch.core.lattice.chain` — the cost model, configuration /
  constraint types, the exhaustive chain oracle, and the three exact
  chain DPs (:class:`PartitionLattice`, :class:`BottleneckLattice`,
  :class:`ParetoLattice`).  A chain is the degenerate series-only case of
  the series-parallel decomposition, so everything here is byte-identical
  to the pre-refactor behaviour.
* :mod:`~repro_torch.core.lattice.dag` — the DAG generalisation of the cost
  model: :class:`DagCostModel` prices *assignments* (one resource per
  block) over a :class:`~repro_torch.core.graph.BlockDag`, with per-edge
  transfer costs, critical-path latency and per-resource pipelined
  bottleneck math; :class:`DagPartitionConfig` is the operating-point
  carrier.
* :mod:`~repro_torch.core.lattice.oracle` — the DAG-aware exhaustive oracle
  (tier-monotone assignment enumeration) and the counted search space the
  query engine's strategy auto-dispatch uses.
* :mod:`~repro_torch.core.lattice.sp` — :class:`SPSolver`, the DP over the
  series-parallel decomposition tree: series composition is the chain
  transition, parallel composition merges per-branch label sets, and the
  in-state constraint handling (``max_resource_time`` / ``min_blocks_on``)
  carries over from the chain lattices.

``core/partition.py`` remains as a thin re-export shim over this package.
"""

from .chain import *                                   # noqa: F401,F403
from .chain import (_LatticeBase, _nondominated_rows,  # noqa: F401
                    _objective_vector)
from .dag import (DagCostModel, DagPartitionConfig)    # noqa: F401
from .oracle import (dag_config_satisfies, dag_search_space,  # noqa: F401
                     enumerate_dag_partitions)
from .sp import SPSolver                               # noqa: F401
