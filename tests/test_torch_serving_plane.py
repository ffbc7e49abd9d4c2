"""The port's serving plane and fault-tolerance helpers against the JAX
package's, on the CPU.

``repro_torch.serving`` (requests, queues, metrics, sim, router) and
``repro_torch.runtime.ft`` are copies of JAX-free reference modules with
only their imports changed, so every result must match exactly: the same
seeded traces, the same simulated pipeline rates, the same router reports
(with a live operating-point swap), the same queue, cache-pool and bucket
states, and the same straggler and heartbeat verdicts under an injected
clock.  Operating points come from each package's fleet-sized query
engine (``benchmarks/common*.py`` ``fleet_engine``, analytic DBs over the
same synthetic graph under the same network), held equal before they are
served.
"""

import dataclasses
import sys
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

import repro.runtime.ft as jft
import repro.serving as jserving
from repro.core import Query as JQuery

import repro_torch.runtime.ft as tft
import repro_torch.serving as tserving
from repro_torch.core import (FOUR_G, AnalyticProvider, Link, NetworkModel,
                              Query, Resource, Scission, TensorSpec)
from repro_torch.core.resources import CLOUD_VM, EDGE_BOX_1
from repro_torch.kernel_graph import dense_node
from repro_torch.core.graph import linear_graph
from repro_torch.serving.router import stage_layout

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))   # benchmarks/
from benchmarks import common as jcommon  # noqa: E402
from benchmarks import common_torch as tcommon  # noqa: E402

PACKAGES = {"jax": (jserving, jcommon, JQuery), "torch": (tserving, tcommon,
                                                        Query)}
_ENGINES: dict = {}


def _engine(which):
    """A small fleet engine of each package: 3 x 2 resources, 6 blocks,
    under 4G at the reference's network scale (the port's own scale comes
    from the card's calibration)."""
    if which not in _ENGINES:
        with mock.patch.dict(tcommon.NETWORKS, {"4g": tcommon.scaled(
                FOUR_G, jcommon.TIME_SCALE)}):
            _ENGINES[which] = PACKAGES[which][1].fleet_engine(n_per_tier=2,
                                                              n_blocks=6)
    return _ENGINES[which]


def _points(which):
    """Latency-ranked configs and a replicated throughput frontier."""
    eng, query = _engine(which), PACKAGES[which][2]
    ranked = eng.run(query(top_n=4)).configs
    front = eng.frontier(query(replicas={"device0": 4, "device1": 4,
                                         "edge0": 3, "edge1": 3})).configs
    return ranked + sorted(front, key=lambda c: (-c.throughput_rps,
                                                 c.describe()))


def _key(cfg):
    return (cfg.describe(), cfg.latency_s, cfg.throughput_rps,
            cfg.batch_size, tuple(cfg.replicas))


def _fields(obj):
    return dataclasses.asdict(obj)


def test_fleet_operating_points_match():
    want = [_key(c) for c in _points("jax")]
    assert [_key(c) for c in _points("torch")] == want
    assert any(max(c.replicas) > 1 for c in _points("torch"))


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("prompt_len", [32, (8, 200)])
def test_poisson_trace_matches(seed, prompt_len):
    want = jserving.poisson_trace(37.5, 20.0, seed=seed,
                                  prompt_len=prompt_len)
    got = tserving.poisson_trace(37.5, 20.0, seed=seed,
                                 prompt_len=prompt_len)
    assert [_fields(a) for a in got] == [_fields(a) for a in want]
    assert tserving.empirical_rate(got) == jserving.empirical_rate(want)


@pytest.mark.parametrize("seed", [1, 4])
def test_bursty_diurnal_trace_matches(seed):
    kw = dict(base_rps=10.0, peak_rps=40.0, horizon_s=60.0, period_s=30.0,
              seed=seed, burst_factor=1.5, burst_every_s=15.0,
              burst_len_s=3.0, prompt_len=(16, 128))
    want = jserving.bursty_diurnal_trace(**kw)
    got = tserving.bursty_diurnal_trace(**kw)
    assert [_fields(a) for a in got] == [_fields(a) for a in want]


def test_arrivals_to_requests_matches():
    trace = jserving.poisson_trace(20.0, 5.0, seed=2, prompt_len=(4, 40))
    ttrace = tserving.poisson_trace(20.0, 5.0, seed=2, prompt_len=(4, 40))
    want = jserving.arrivals_to_requests(trace, vocab=97, seed=5)
    got = tserving.arrivals_to_requests(ttrace, vocab=97, seed=5)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.rid, g.max_new_tokens, g.submitted_at) == \
            (w.rid, w.max_new_tokens, w.submitted_at)
        np.testing.assert_array_equal(g.prompt, w.prompt)


@pytest.mark.parametrize("n_requests", [2, 64, 300])
def test_simulate_pipeline_throughput_matches(n_requests):
    jpts, tpts = _points("jax"), _points("torch")
    want = [jserving.simulate_pipeline_throughput(c, n_requests)
            for c in jpts]
    got = [tserving.simulate_pipeline_throughput(c, n_requests)
           for c in tpts]
    assert got == want


def test_simulate_pipeline_throughput_refuses_what_the_reference_does():
    point = _points("torch")[0]
    with pytest.raises(ValueError, match="at least 2"):
        tserving.simulate_pipeline_throughput(point, 1)
    bad = dataclasses.replace(point, replicas=(0,) * len(point.segments))
    with pytest.raises(ValueError, match=">= 1"):
        tserving.simulate_pipeline_throughput(bad)


def _serve(which, slo, swap):
    """Serve a seeded Poisson trace at the fleet's top-throughput point,
    swapping to the latency-best point halfway through when ``swap``."""
    serving = PACKAGES[which][0]
    pts = _points(which)
    point = max(pts, key=lambda c: (c.throughput_rps, c.describe()))
    trace = serving.poisson_trace(1.2 * point.throughput_rps, 30.0, seed=7)
    router = serving.Router(point, slo_s=slo, queue_limit=16)
    for a in trace:
        if swap and a.t >= 15.0 and not router.swaps:
            router.set_operating_point(pts[0])
        router.offer(a)
    router.flush()
    rep = router.report()
    layout = serving.router.stage_layout(router.point)
    return rep.as_dict(), router.swaps, layout


@pytest.mark.parametrize("slo,swap", [(None, False), (0.5, False),
                                      (None, True), (0.5, True)])
def test_router_over_virtual_backend_matches(slo, swap):
    want = _serve("jax", slo, swap)
    got = _serve("torch", slo, swap)
    assert got == want
    rep = got[0]
    assert rep["arrivals"] == rep["completed"] + rep["shed"]
    assert len(got[1]) == int(swap)


def test_router_bursty_with_slo_matches():
    reports = []
    for which in ("jax", "torch"):
        serving = PACKAGES[which][0]
        point = max(_points(which), key=lambda c: (c.throughput_rps,
                                                   c.describe()))
        pred = point.throughput_rps
        trace = serving.bursty_diurnal_trace(
            base_rps=0.5 * pred, peak_rps=2.0 * pred, horizon_s=40.0,
            period_s=20.0, seed=1, burst_factor=1.5, burst_every_s=10.0,
            burst_len_s=2.0)
        slo = max(20.0 * point.bottleneck_s, 2.0 * point.latency_s)
        reports.append(serving.Router(point, slo_s=slo).serve(trace)
                       .as_dict())
    assert reports[1] == reports[0]
    assert reports[1]["shed"] > 0


def test_stage_queue_matches():
    rng = np.random.default_rng(0)
    ops = rng.integers(0, 3, 200)
    states = []
    for serving in (jserving, tserving):
        q = serving.StageQueue(limit=5)
        popped = []
        for i, op in enumerate(ops):
            if op and q:
                popped.append(q.pop())
            else:
                q.push(i)
        states.append((popped, q.depth, q.offered, q.rejected, q.peak_depth,
                       dict(q.depth_histogram)))
    assert states[1] == states[0]
    for serving in (jserving, tserving):
        with pytest.raises(ValueError):
            serving.StageQueue(limit=0)


def test_prompt_buckets_match():
    assert tserving.PROMPT_BUCKETS == jserving.PROMPT_BUCKETS
    ns = np.random.default_rng(1).integers(1, 3000, 100)
    assert [tserving.bucket_for(int(n), tserving.PROMPT_BUCKETS)
            for n in ns] == [jserving.bucket_for(int(n),
                                                 jserving.PROMPT_BUCKETS)
                             for n in ns]
    for serving in (jserving, tserving):
        with pytest.raises(ValueError):
            serving.bucket_for(0, serving.PROMPT_BUCKETS)


class _CacheModel:
    """The one method ``KVCachePool`` asks of a model."""

    def init_cache(self, batch, max_len):
        return {"k": np.zeros((batch, max_len, 2), np.float32)}


def test_kv_cache_pool_matches():
    rng = np.random.default_rng(2)
    steps = rng.integers(0, 2, 120)
    states = []
    for serving in (jserving, tserving):
        pool = serving.KVCachePool(_CacheModel(), width=6, max_len=16)
        got, rid = [], 0
        for op in steps:
            if op or not pool.slot_req:
                got.append(pool.acquire(rid))
                rid += 1
            else:
                slot = sorted(pool.slot_req)[rid % len(pool.slot_req)]
                pool.lengths[slot] = rid % 16
                pool.release(slot)
                got.append(-slot)
        states.append((got, list(pool.free), dict(pool.slot_req),
                       pool.lengths.tolist(), pool.cache["k"].shape))
    assert states[1] == states[0]
    assert None in states[1][0]                      # the pool ran full


def test_metrics_match():
    xs = np.random.default_rng(3).exponential(0.05, 257).tolist()
    for p in (1, 50, 90, 99, 100):
        assert tserving.percentile(xs, p) == jserving.percentile(xs, p)
    for serving in (jserving, tserving):
        with pytest.raises(ValueError):
            serving.percentile(xs, 0)
    assert tserving.mean(xs) == jserving.mean(xs)
    assert np.isnan(tserving.mean([])) == np.isnan(jserving.mean([]))


def test_straggler_detector_matches():
    rng = np.random.default_rng(4)
    verdicts = []
    for ft in (jft, tft):
        det = ft.StragglerDetector(window=8, k=4.0)
        out = []
        for step in range(40):
            for host in range(6):
                slow = 3.0 if host == 4 and step >= 20 else 1.0
                det.record(host, slow * (1.0 + 0.05 * rng.standard_normal()))
            out.append(det.stragglers())
        verdicts.append(out)
        rng = np.random.default_rng(4)
    assert verdicts[1] == verdicts[0]
    assert verdicts[1][-1] == [4] and verdicts[1][0] == []


def test_heartbeat_registry_with_injected_clock_matches():
    results = []
    for ft in (jft, tft):
        clock = [0.0]
        reg = ft.HeartbeatRegistry(timeout_s=10.0, now=lambda: clock[0])
        out = []
        for t, member in [(0.0, "a"), (1.0, "b"), (5.0, "c"), (12.0, "b"),
                          (14.0, "c"), (30.0, "a")]:
            clock[0] = t
            reg.beat(member)
            out.append((reg.dead(), reg.members()))
        clock[0] = 41.0
        out.append((reg.dead(), reg.members()))
        results.append(out)
    assert results[1] == results[0]
    assert results[1][3][0] == ["a"]


def test_shard_assignment_and_supervisor_match():
    class Ckpt:
        def __init__(self):
            self.saved = []

        def save(self, step, state):
            self.saved.append(step)

        def restore_latest(self, like):
            return None

    runs = []
    for ft in (jft, tft):
        shards = ft.ShardAssignment(n_shards=10, hosts=[3, 1, 2])
        a = dict(shards.assignment)
        b = shards.drop_host(2)
        ckpt = Ckpt()
        sup = ft.TrainSupervisor(ckpt, ckpt_every=5,
                                 detector=ft.StragglerDetector(k=3.0))
        state, start = sup.resume_or_init(lambda: ("init",), like={})
        flagged = [sup.after_step(s, state, 1.0 + (s % 7 == 0), host=s % 3)
                   for s in range(start, 16)]
        runs.append((a, b, state, start, ckpt.saved, sup.events, flagged))
    assert runs[1] == runs[0]


def test_executor_backend_measures_the_ports_pipeline_on_the_cpu():
    """``ExecutorBackend`` runs the port's ``PipelineExecutor`` on the
    device it is given: one service time per stage of the layout."""
    rng = np.random.default_rng(5)
    w = {n: torch.from_numpy(rng.standard_normal((16, 16)).astype(
        np.float32) * 0.1) for n in ("a", "b", "c")}
    graph = linear_graph("mlp", TensorSpec((1, 16), torch.float32),
                         [dense_node(n, w[n]) for n in ("a", "b", "c")])
    res = [Resource("device", "device", EDGE_BOX_1, speed_factor=4.0),
           Resource("cloud", "cloud", CLOUD_VM)]
    net = NetworkModel(default=Link("wired", 0.001, 1e6))
    s = Scission(res, net, "device", provider=AnalyticProvider(), runs=1,
                 device="cpu")
    s.benchmark(graph)
    point = next(c for c in s.query("mlp", Query(top_n=20),
                                    input_bytes=64.0).configs
                 if len(c.segments) > 1)
    backend = tserving.ExecutorBackend(
        graph, lambda b: torch.ones(b, 16), network=net, source="device",
        speed_factors={r.name: r.speed_factor for r in res}, device="cpu")
    router = tserving.Router(point, backend=backend)
    times = backend.stage_times()
    assert len(times) == len(stage_layout(point))
    assert all(t >= 0.0 for t in times)
    rep = router.serve(tserving.poisson_trace(5.0, 2.0, seed=0))
    assert rep.arrivals == rep.completed + rep.shed
