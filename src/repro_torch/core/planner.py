"""Scission facade — the six-step methodology end to end (paper Figure 5).

    scission = Scission(resources, network, source="device")
    scission.benchmark(graph)                       # Steps 1-3 (offline)
    result = scission.query(graph.name, Query(...)) # Steps 4-6 (<50 ms)

Benchmark databases persist to disk so Steps 1-3 run once per
(model, resource set) and every later query is an in-memory ranking pass —
this is the property the elastic runtime (runtime/elastic.py) relies on to
re-plan within the paper's query budget when a resource joins or leaves.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .._device import resolve_device
from .bench import (BenchmarkDB, BenchmarkProvider, TimingProvider,
                    benchmark_batches, benchmark_model)
from .graph import BlockDag, LayerGraph, fuse_block_dag, fuse_blocks
from .network import NetworkModel
from .partition import PartitionConfig
from .query import Query, QueryEngine, QueryResult
from .resources import Resource


@dataclass
class Scission:
    resources: list[Resource]
    network: NetworkModel
    source: str
    provider: BenchmarkProvider | None = None
    runs: int = 5
    # where the default TimingProvider measures; "cpu" for tests
    device: str | torch.device = "cuda"

    def __post_init__(self):
        self.device = resolve_device(self.device)
        if self.provider is None:
            self.provider = TimingProvider(device=self.device)
        self._dbs: dict[str, BenchmarkDB] = {}
        self._engines: dict[tuple[str, float], QueryEngine] = {}
        # models benchmarked with dag=True: their BlockDag (block-level
        # edges + SP decomposition tree), handed to every query engine so
        # solves run the DAG-general paths
        self._dags: dict[str, BlockDag] = {}

    # -- Steps 1-3 -----------------------------------------------------------
    def _set_db(self, db: BenchmarkDB) -> None:
        """Install a model DB and drop that model's cached query engines —
        an engine holds a direct reference to the DB it was built from, so
        keeping it would price later queries against stale measurements."""
        self._dbs[db.model] = db
        self._engines = {k: v for k, v in self._engines.items()
                         if k[0] != db.model}

    def _blocks_for(self, graph: LayerGraph):
        """The block structure queries for this model run over: the stored
        BlockDag when the model was benchmarked with ``dag=True`` (indices
        must line up with the DB records), plain chain fusing otherwise."""
        dag = self._dags.get(graph.name)
        return dag if dag is not None else fuse_blocks(graph)

    def benchmark(self, graph: LayerGraph,
                  batch_sizes: tuple[int, ...] = (1,),
                  dag: bool = False) -> BenchmarkDB:
        """Steps 1-3.  ``batch_sizes`` > (1,) records a batch profile per
        (block, resource) so throughput queries can price batched stages.

        ``dag=True`` fuses with :func:`fuse_block_dag` — parallel regions
        of the layer graph survive as block-level branches, and every query
        for this model runs the DAG-general partitioner (SP-decomposition
        DP / DAG-aware exhaustive) instead of the chain engines.  On a
        purely linear graph the two fusings are identical and queries stay
        on the chain paths.
        """
        if dag:
            blocks = fuse_block_dag(graph)
            self._dags[graph.name] = blocks
        else:
            self._dags.pop(graph.name, None)
            blocks = fuse_blocks(graph)
        db = benchmark_model(graph, self.resources, self.provider,
                             runs=self.runs, batch_sizes=batch_sizes,
                             blocks=blocks)
        self._set_db(db)
        return db

    def benchmark_resource(self, graph: LayerGraph, resource,
                           batch_sizes: tuple[int, ...] | None = None
                           ) -> BenchmarkDB:
        """Incremental Step 3 for one newly-joined resource: existing
        records are reused, only the new resource's blocks are measured.

        The newcomer is measured at the same batch sizes as the existing
        DB (or ``batch_sizes`` when given), so batched operating points
        stay answerable after an elastic join.
        """
        db = self._dbs.get(graph.name)
        if batch_sizes is None:
            batch_sizes = tuple(db.measured_batches(
                [r.name for r in self.resources])) if db is not None else (1,)
        new = benchmark_model(graph, [resource], self.provider,
                              runs=self.runs, batch_sizes=batch_sizes,
                              blocks=self._blocks_for(graph))
        if db is None:
            self._set_db(new)
            return new
        db.records[resource.name] = new.records[resource.name]
        self._set_db(db)
        return db

    def benchmark_batches(self, graph: LayerGraph,
                          batch_sizes: tuple[int, ...]) -> BenchmarkDB:
        """Incremental Step 3 over batch sizes: measure only the batches the
        model's DB has not already profiled and merge them in place (the
        batch-axis analogue of :meth:`benchmark_resource`)."""
        db = self._dbs.get(graph.name)
        if db is None:
            return self.benchmark(graph, batch_sizes=batch_sizes)
        benchmark_batches(db, graph, self.resources, self.provider,
                          runs=self.runs, batch_sizes=batch_sizes,
                          blocks=self._blocks_for(graph))
        self._set_db(db)
        return db

    def load(self, db: BenchmarkDB) -> None:
        self._set_db(db)

    def save(self, model: str, path: str) -> None:
        with open(path, "w") as f:
            f.write(self._dbs[model].to_json())

    def restore(self, path: str) -> BenchmarkDB:
        with open(path) as f:
            db = BenchmarkDB.from_json(f.read())
        self._set_db(db)
        return db

    # -- Steps 4-6 -----------------------------------------------------------
    def engine(self, model: str, input_bytes: float) -> QueryEngine:
        key = (model, float(input_bytes))
        if key not in self._engines:
            dag = self._dags.get(model)
            self._engines[key] = QueryEngine(
                self._dbs[model], self.resources, self.network,
                source=self.source, input_bytes=input_bytes,
                block_preds=dag.preds if dag is not None else None,
                sp_tree=dag.tree if dag is not None else None)
        return self._engines[key]

    def query(self, model: str, query: Query | None = None,
              input_bytes: float = 150e3) -> QueryResult:
        """150 KB default input — the paper's standard image size."""
        return self.engine(model, input_bytes).run(query)

    def best(self, model: str, input_bytes: float = 150e3) -> PartitionConfig:
        return self.query(model, Query(top_n=1), input_bytes).best

    def frontier(self, model: str, query: Query | None = None,
                 input_bytes: float = 150e3,
                 strategy: str | None = None) -> QueryResult:
        """Pareto non-dominated set over (latency, throughput, transfer).

        ``strategy`` forces the execution strategy ("exhaustive" keeps the
        validation-oracle enumeration, "lattice" the exact
        :class:`ParetoLattice` path); default picks by search-space size.
        """
        return self.engine(model, input_bytes).frontier(query,
                                                        strategy=strategy)

    # -- operational changes (motivation (vi), elastic runtime hook) ---------
    def with_resources(self, resources: list[Resource]) -> "Scission":
        """Re-plan with a changed resource set (maintenance, failure, join)
        WITHOUT re-benchmarking: the per-(block, resource) records of any
        resource still present are reused.

        A model's DB is kept even when some *new* resource has no records
        yet — dropping it would silently discard all prior benchmarking.
        Querying such a model raises a clear "resource X not benchmarked
        for model Y" error at engine construction (CostModel validates);
        run :meth:`benchmark_resource` for the newcomer first.
        """
        s = Scission(resources=resources, network=self.network,
                     source=self.source, provider=self.provider,
                     runs=self.runs, device=self.device)
        s._dags = dict(self._dags)
        names = {r.name for r in resources}
        for model, db in self._dbs.items():
            kept = {r: recs for r, recs in db.records.items() if r in names}
            if kept:
                ndb = BenchmarkDB(model=db.model, n_blocks=db.n_blocks)
                ndb.records = kept
                s._dbs[model] = ndb
        return s
