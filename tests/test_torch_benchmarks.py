"""The port's paper benchmarks against the JAX package's, on the CPU.

No zoo net is timed and no JAX zoo net is built (each build takes seconds):
both packages read the same analytic BenchmarkDBs, made once by the port's
``AnalyticProvider`` from its ``meta`` builds of the nets at batch sizes
1, 2 and 4 (``tests/test_torch_zoo_numerics.py`` holds such a DB
byte-identical to the JAX package's own).  ``benchmark_cached`` and
``scission_for`` are replaced in both packages' benchmark modules by that
DB and an analytic provider, under the reference's network scale, and the
one incremental benchmark the scenarios make (a resource that joins) is
priced the same way on the reference's side.  Then every decision, row
value and gate verdict that does not time this host must be equal; the
gates that do (query and re-plan wall time, the fleet frontier's budget,
the perf gate) run on both sides, and only their rows are compared.
"""

import dataclasses
import sys
from pathlib import Path

import pytest
import torch

import repro.core as jcore
import repro.core.planner as jplanner
import repro.models.cnn_zoo as jzoo
from repro.core.partition import PartitionLattice as JLattice

import repro_torch.core as tcore
from repro_torch.core.partition import PartitionLattice as TLattice
from repro_torch.models import cnn_zoo

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))   # benchmarks/
from benchmarks import bench_autotune_torch as tba  # noqa: E402
from benchmarks import bench_elastic as jbe  # noqa: E402
from benchmarks import bench_elastic_torch as tbe  # noqa: E402
from benchmarks import bench_overhead_torch as tbo  # noqa: E402
from benchmarks import bench_partitions as jbp  # noqa: E402
from benchmarks import bench_partitions_torch as tbp  # noqa: E402
from benchmarks import bench_query as jbq  # noqa: E402
from benchmarks import bench_query_torch as tbq  # noqa: E402
from benchmarks import bench_serving as jbs  # noqa: E402
from benchmarks import bench_serving_torch as tbs  # noqa: E402
from benchmarks import common as jcommon  # noqa: E402
from benchmarks import common_torch as tcommon  # noqa: E402
from benchmarks import run_torch  # noqa: E402

BATCHES = (1, 2, 4)
_DBS: dict = {}
# rows whose derived value is a wall time or a ratio of wall times
TIMED = ("gate/", "front_replan/steady", "front_replan/drop_barred",
         "front_replan/join", "query/", "elastic/warm_query")


def _port_resource(r):
    """A reference Resource as the port's."""
    dev = tcore.DeviceModel(**{f.name: getattr(r.device, f.name)
                               for f in dataclasses.fields(tcore.DeviceModel)})
    return tcore.Resource(r.name, r.tier, dev, speed_factor=r.speed_factor)


def _analytic_records(name, resources, batch_sizes):
    """The port's analytic DB of ``name`` on ``resources`` as JSON."""
    graph = cnn_zoo.build(name, "meta")
    return tcore.benchmark_model(graph, resources, tcore.AnalyticProvider(),
                                 runs=1, batch_sizes=batch_sizes).to_json()


def _db_json(name):
    if name not in _DBS:
        _DBS[name] = _analytic_records(name, tcommon.testbed(), BATCHES)
    return _DBS[name]


class _NetName:
    """What the reference's scenarios hold of a net they would build: its
    name, which the analytic join below prices."""

    def __init__(self, name):
        self.name = name


def _join_by_name(self, graph, resource, batch_sizes=None):
    """The reference planner's incremental benchmark of one resource, from
    the port's analytic records of the same net (no JAX zoo build)."""
    db = self._dbs[graph.name]
    batch_sizes = batch_sizes or tuple(db.measured_batches(
        [r.name for r in self.resources]))
    new = jcore.BenchmarkDB.from_json(_analytic_records(
        graph.name, [_port_resource(resource)], batch_sizes))
    db.records[resource.name] = new.records[resource.name]
    self._set_db(db)
    return db


@pytest.fixture
def analytic(monkeypatch, tmp_path):
    """Both packages' benchmarks over the shared analytic DBs."""
    monkeypatch.setattr(tcommon, "CACHE_ROOT", str(tmp_path))
    for net, link in (("3g", tcore.THREE_G), ("4g", tcore.FOUR_G),
                      ("wired", tcore.WIRED)):
        monkeypatch.setitem(tcommon.NETWORKS, net,
                            tcommon.scaled(link, jcommon.TIME_SCALE))

    def port_scission(net, resources=None, device="cpu"):
        s = tcommon.scission_for(net, resources, device="cpu")
        s.provider = tcore.AnalyticProvider()
        return s

    def ref_scission(net, resources=None):
        s = jcommon.scission_for(net, resources)
        s.provider = jcore.AnalyticProvider()
        return s

    def port_cached(s, name, batch_sizes=(1,)):
        return _load(s, tcore.BenchmarkDB, name)

    def ref_cached(s, name, batch_sizes=(1,)):
        return _load(s, jcore.BenchmarkDB, name)

    for mod in (tbp, tbq, tbe, tbs):
        monkeypatch.setattr(mod, "scission_for", port_scission)
        monkeypatch.setattr(mod, "benchmark_cached", port_cached)
    for mod in (jbp, jbq, jbe, jbs):
        monkeypatch.setattr(mod, "scission_for", ref_scission)
        monkeypatch.setattr(mod, "benchmark_cached", ref_cached)
    monkeypatch.setattr(jzoo, "build", lambda name, *a, **k: _NetName(name))
    monkeypatch.setattr(jplanner.Scission, "benchmark_resource",
                        _join_by_name)
    monkeypatch.setattr(tbp, "_SCISSIONS", {})
    monkeypatch.setattr(jbp.scenario_network, "_cache", {})


def _load(s, db_cls, name):
    db = db_cls.from_json(_db_json(name))
    s.load(db)
    return db


def _decisions(rows):
    return [(name, derived) for name, _, derived in rows
            if not name.startswith(TIMED)]


def _timed(rows):
    return [name for name, _, _ in rows if name.startswith(TIMED)]


@pytest.mark.parametrize("n_per_tier,n_blocks", [(2, 6), (4, 12)])
def test_fleet_engine_k_best_matches_reference(monkeypatch, n_per_tier,
                                               n_blocks):
    monkeypatch.setitem(tcommon.NETWORKS, "4g", tcommon.scaled(
        tcore.FOUR_G, jcommon.TIME_SCALE))
    jeng = jcommon.fleet_engine(n_per_tier, n_blocks)
    teng = tcommon.fleet_engine(n_per_tier, n_blocks)
    assert teng._search_space() == jeng._search_space()
    assert teng.db.to_json() == jeng.db.to_json()

    def best(lattice, eng):
        return [(c.describe(), c.latency_s)
                for c in lattice(eng.cost).solve(top_n=8)]

    assert best(TLattice, teng) == best(JLattice, jeng)
    sort_push = [c.latency_s for c in tbq._SortPushLattice(teng.cost)
                 .solve(top_n=8)]
    assert sort_push == [lat for _, lat in best(TLattice, teng)]


def test_port_fleet_engine_uses_the_ports_network():
    eng = tcommon.fleet_engine(2, 6)
    assert eng.network.link("device0", "cloud1") == tcommon.NETWORKS["4g"]
    assert len(eng.resources) == 6 and eng.source == "device0"


@pytest.mark.parametrize("mode", ["smoke", "smoke_frontier",
                                  "smoke_batched"])
def test_partitions_smoke_modes_match_reference(analytic, mode):
    want = getattr(jbp, mode)()
    got = getattr(tbp, mode)(device="cpu")
    assert _decisions(got) == _decisions(want)
    assert _timed(got) == _timed(want)
    deterministic = ("throughput", "batched", "frontier_exact",
                     "frontier_constrained")
    for name in deterministic:
        assert getattr(tbp, f"scenario_{name}").failures == \
            getattr(jbp, f"scenario_{name}").failures
    mismatch = [f for f in tbp.scenario_replan.failures
                if f.startswith("replan-mismatch")]
    assert mismatch == [f for f in jbp.scenario_replan.failures
                        if f.startswith("replan-mismatch")]
    assert not [f for f in tbp.failures() if not f.startswith(
        ("replan-slow", "fleet/"))]


def test_partitions_run_matches_reference_without_the_dag_scenario(
        analytic, monkeypatch):
    """``run(quick=True)``: every scenario but the DAG one, which both
    packages run last and test_dag_scenario_matches_reference compares."""
    monkeypatch.setattr(jbp, "scenario_dag", lambda quick=True: [])
    monkeypatch.setattr(tbp, "scenario_dag",
                        lambda quick=True, device="cuda": [])
    want = jbp.run(quick=True)
    got = tbp.run(quick=True, device="cpu")
    assert _decisions(got) == _decisions(want)
    assert not any(name.startswith("dag") for name, _, _ in got)


def test_dag_scenario_matches_reference(analytic):
    """``scenario_dag`` (``--smoke-dag``): the MoE layer and the reduced
    enc-dec LM of each package, fused as block DAGs and priced by the
    analytic provider from the adapters' equal FLOPs and bytes; every
    decision, frontier size, split count and gate verdict equal."""
    want = jbp.scenario_dag(quick=True)
    got = tbp.smoke_dag(device="cpu")
    assert _decisions(got) == _decisions(want)
    assert [name for name, _, _ in got] == [name for name, _, _ in want]
    assert tbp.scenario_dag.failures == jbp.scenario_dag.failures == []
    assert dict((n, d) for n, _, d in got)["dag/split_points"] > 0


def test_perf_gate_runs_the_chain_frontier_gates(analytic):
    """The chain frontier gates on MobileNetV2, after the SP solve and
    frontier gates on the DAG graphs, as the reference's perf gate."""
    rows = tbp.perf_gate(reps=2, device="cpu")
    names = [name for name, _, _ in rows]
    assert names[-3:] == [f"gate/front_chain/{net}/MobileNetV2"
                          for net in ("3g", "4g", "wired")]
    assert names == [name for name, _, _ in jbp.perf_gate(reps=2)]
    assert any(name.startswith("gate/dag_sp/") for name in names)
    assert any(name.startswith("gate/front_dag/") for name in names)


def test_serving_smoke_matches_reference(analytic):
    want = jbs.smoke()
    got = tbs.smoke(device="cpu")
    assert got == want
    assert tbs.failures() == []
    assert got["poisson"]["rel_err"] <= tbs.GOODPUT_TOLERANCE


def test_query_bench_matches_reference(analytic):
    want = jbq.run(quick=True)
    got = tbq.run(quick=True, device="cpu")
    assert [name for name, _, _ in got] == [name for name, _, _ in want]
    assert not [f for f in tbq.run.failures if "push" in f]


def test_elastic_bench_matches_reference(analytic):
    want = jbe.run(quick=True)
    got = tbe.run(quick=True, device="cpu")
    assert _decisions(got) == _decisions(want)
    assert _timed(got) == _timed(want)


def test_overhead_bench_times_each_tier_on_meta():
    rows = tbo.run(quick=True, device="meta")
    assert [name for name, _, _ in rows] == [
        "overhead/MobileNetV2", "overhead/ResNet50", "overhead/VGG16"]
    assert all(us > 0 and ratio > 0 for _, us, ratio in rows)


def test_benchmark_cached_never_loads_another_timing_tag(tmp_path,
                                                         monkeypatch):
    """A DB under another timing tag, or under the untagged layout of eager
    card timings, is never read: the net is benchmarked anew, and the DB
    written under this device's tag is read back the next time."""
    monkeypatch.setattr(tcommon, "CACHE_ROOT", str(tmp_path))
    s = tcommon.scission_for("4g", device="meta")
    s.provider = tcore.AnalyticProvider()
    assert tcommon.cache_dir(s.device) == str(tmp_path / "meta" / "eager")
    stale = tcore.BenchmarkDB.from_json(_analytic_records(
        "MobileNet", tcommon.testbed(), (1,)))
    for recs in stale.records.values():
        for rec in recs:
            rec.mean_time_s = 123.0
            rec.batch_profile = {1: (123.0, rec.output_bytes)}
    for where in ("meta", "meta/cudagraph"):
        (tmp_path / where).mkdir(parents=True, exist_ok=True)
        (tmp_path / where / "MobileNet.json").write_text(stale.to_json())
    db = tcommon.benchmark_cached(s, "MobileNet")
    assert all(rec.mean_time_s != 123.0
               for recs in db.records.values() for rec in recs)
    assert (tmp_path / "meta" / "eager" / "MobileNet.json").is_file()
    monkeypatch.setattr(cnn_zoo, "build", None)      # no rebuild: a hit
    again = tcommon.benchmark_cached(s, "MobileNet")
    assert again.to_json() == db.to_json()


def test_cache_tag_names_each_timing_method():
    assert tcommon.TIMING == {"cuda": "cudagraph", "cpu": "eager",
                              "meta": "eager"}
    assert tcommon.cache_dir(torch.device("cpu")).endswith("cpu/eager")


def test_run_torch_exits_1_when_a_gate_fails(monkeypatch, capsys):
    """The harness prints every bench's rows and fails on any gate."""
    for mod in (tbo, tbq, tbe):
        monkeypatch.setattr(mod, "run", lambda quick=True, device="cuda",
                            _m=mod.__name__: [(f"{_m}/row", 1.0, 2)])
    from benchmarks import bench_zoo_torch
    monkeypatch.setattr(bench_zoo_torch, "run",
                        lambda quick=True, device="cuda": [("zoo/x", 1.0, 3)])
    monkeypatch.setattr(tbp, "run", lambda quick=True, device="cuda":
                        [("net/x", 1.0, 0.5)])
    monkeypatch.setattr(tbs, "smoke", lambda device="cuda": {
        "poisson": {"rel_err": 0.01}, "replan": {"swaps": 1}})
    monkeypatch.setattr(tbq.run, "failures", [], raising=False)
    autotune = lambda quick=True, device="cuda": [("autotune/x", 1.0, 1)]  # noqa: E731
    autotune.failures = []
    monkeypatch.setattr(tba, "run", autotune)
    for fn in (tbp.scenario_throughput, tbp.scenario_batched,
               tbp.scenario_frontier_exact, tbp.scenario_frontier_constrained,
               tbp.scenario_frontier_scale, tbp.scenario_replan, tbp.perf_gate,
               tbs.scenario_poisson, tbs.scenario_bursty, tbs.scenario_replan):
        monkeypatch.setattr(fn, "failures", [])
    monkeypatch.setattr(sys, "argv", ["run_torch", "--device", "cpu"])
    run_torch.main()
    out = capsys.readouterr().out
    assert "name,us_per_call,derived" in out and "zoo/x,1.0,3" in out
    monkeypatch.setattr(tbp.scenario_throughput, "failures", ["4g/X"])
    with pytest.raises(SystemExit) as exc:
        run_torch.main()
    assert exc.value.code == 1
    assert "FAILED gates: 4g/X" in capsys.readouterr().out


@pytest.mark.parametrize("device", ["meta", "cpu"])
def test_autotune_gates_pass_with_a_stub_measure(device):
    """bench_autotune_torch's sweep -> DB -> query, and both pruning gates:
    with every candidate timed alike the defaults win, so the shared-memory
    gate's limit (the winners' largest footprint, SSD chunk 128's 58,368 B)
    prunes chunk 256 before timing; the tiling gate prunes bf16 block_q
    48; both winners come out bit-identical."""
    rows = tba.run(device=device, measure=lambda fn, args: 1.0)
    assert tba.run.failures == []
    gate, tgate = tba.run.last_gate, tba.run.last_tiling_gate
    assert gate["limit_bytes"] == 58368 and gate["all_winners_identical"]
    assert gate["kernels"]["ssd_scan"]["pruned"] == {'{"chunk": 256}': 106496.0}
    assert gate["kernels"]["flash_attention"]["pruned"] == {}
    assert list(tgate["tile_pruned"]) == ['{"block_k": 64, "block_q": 48}']
    assert tgate["misaligned_measured_unpruned"]
    assert not tgate["misaligned_in_gated_trials"]
    assert tgate["winner_identical"]
    derived = {name: d for name, _, d in rows}
    assert derived["autotune/db_records_tuned"] == 4
    assert derived["autotune/smem_winner_identical"] is True


def test_autotune_smem_gate_fails_when_the_largest_candidate_wins():
    """The gate has teeth: when the last-timed, largest SSD chunk wins, the
    winners' largest footprint prunes nothing and the gate fails."""
    times = iter(0.5 ** i for i in range(100))     # each twice as fast
    tba.run(device="meta", measure=lambda fn, args: next(times))
    assert "smem_gate: no candidate pruned" in tba.run.failures


def test_verify_smem_off_the_card_splits_without_launching():
    report = tba.verify_smem("cpu")
    assert report["limit_bytes"] == 232448 and report["ok"]
    by_path = {(e["kernel"], e["path"]): e["candidates"]
               for e in report["kernels"]}
    gemma = by_path[("flash_attention", "gemma2-9b prefill")]
    assert [(c["params"], c["admitted"]) for c in gemma] == [
        ({"block_q": 64, "block_k": 64}, True),
        ({"block_q": 128, "block_k": 64}, True),
        ({"block_q": 128, "block_k": 128}, False),     # the default
        ({"block_q": 256, "block_k": 64}, False)]      # the smallest pruned
    assert gemma[3]["expected"] == "needs 270336 B of shared memory"
    xlstm = by_path[("ssd_scan", "xlstm-125m mLSTM")]
    assert xlstm[-1]["params"] == {"chunk": 256}
    assert "chunk <= 128 with P and N <= 384" in xlstm[-1]["expected"]
    assert not any("launched" in c for cands in by_path.values()
                   for c in cands)
