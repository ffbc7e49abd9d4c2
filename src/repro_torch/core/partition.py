"""Thin re-export shim over :mod:`repro_torch.core.lattice`.

The partitioning engines formerly defined here live in the
``core/lattice/`` package (``chain.py`` holds the cost model and the three
exact chain DPs; ``dag.py`` / ``oracle.py`` / ``sp.py`` add the
DAG-general engine).  Every name importable from ``repro_torch.core.partition``
before the refactor is still importable here, including the private
helpers some tests reach for.
"""

from .lattice.chain import *                                   # noqa: F401,F403
from .lattice.chain import (_LatticeBase, _nondominated_rows,  # noqa: F401
                            _objective_vector)
from .lattice.dag import DagCostModel, DagPartitionConfig      # noqa: F401
from .lattice.oracle import (dag_config_satisfies,             # noqa: F401
                             dag_search_space,
                             enumerate_dag_partitions)
from .lattice.sp import SPSolver                               # noqa: F401
