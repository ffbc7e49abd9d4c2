"""Scission core: graph IR, benchmarking, partitioning, querying."""

from .graph import (Block, BlockDag, LayerGraph, LayerNode, SPNode,
                    TensorSpec, fuse_block_dag, fuse_blocks, linear_graph,
                    sp_summary)
from .resources import DeviceModel, H100_SXM, Resource, paper_testbed
from .network import (Link, NetworkModel, THREE_G, FOUR_G, WIRED, EDGE_CLOUD,
                      paper_network)
from .bench import (BenchmarkDB, BlockBenchmark, TimingProvider,
                    CompiledCostProvider, AnalyticProvider, benchmark_model,
                    benchmark_batches)
from .partition import (Segment, PartitionConfig, CostModel, Objective,
                        ThroughputObjective, LATENCY, TRANSFER, THROUGHPUT,
                        Constraints, PartitionLattice, BottleneckLattice,
                        ParetoLattice, enumerate_partitions,
                        objective_vector, ordered_pipelines, rank,
                        pareto_frontier, dominates, trim_replicas,
                        DagCostModel, DagPartitionConfig, SPSolver,
                        dag_config_satisfies, dag_search_space,
                        enumerate_dag_partitions)
from .query import Query, QueryEngine, QueryResult
from .planner import Scission

__all__ = [
    "Block", "BlockDag", "LayerGraph", "LayerNode", "SPNode", "TensorSpec",
    "fuse_block_dag", "fuse_blocks", "linear_graph", "sp_summary",
    "DeviceModel", "H100_SXM", "Resource", "paper_testbed",
    "Link", "NetworkModel", "THREE_G", "FOUR_G", "WIRED", "EDGE_CLOUD",
    "paper_network",
    "BenchmarkDB", "BlockBenchmark", "TimingProvider",
    "CompiledCostProvider", "AnalyticProvider",
    "benchmark_model", "benchmark_batches",
    "Segment", "PartitionConfig", "CostModel", "Objective",
    "ThroughputObjective", "LATENCY", "TRANSFER", "THROUGHPUT",
    "Constraints", "PartitionLattice", "BottleneckLattice", "ParetoLattice",
    "enumerate_partitions", "objective_vector", "ordered_pipelines", "rank",
    "pareto_frontier", "dominates", "trim_replicas",
    "DagCostModel", "DagPartitionConfig", "SPSolver",
    "dag_config_satisfies", "dag_search_space", "enumerate_dag_partitions",
    "Query", "QueryEngine", "QueryResult", "Scission",
]
