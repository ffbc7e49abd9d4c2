"""Shared setup of the port's paper-reproduction entry points.

The port's counterpart of ``benchmarks/common.py``.  The card plays the
paper's 'Cloud' box; the other tiers are emulated with the same
paper-derived speed factors, and the network times are scaled by
``TIME_SCALE`` so that the ratio of communication to computation, and with
it the paper's decision geometry, is the one the reference's calibration
gives.  Benchmark DBs are cached under
``results/benchdb_torch/<device>/<timing>``, one directory per device name
and timing method, so a DB timed on one device, or in another way, never
prices a decision on another.
"""

from __future__ import annotations

import math
import os
import re
import subprocess

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core import (FOUR_G, THREE_G, WIRED, AnalyticProvider, Link,
                              LayerNode, NetworkModel, Query, QueryEngine,
                              Resource, Scission, TensorSpec, TimingProvider,
                              benchmark_model, linear_graph, paper_network)
from repro_torch.core.resources import (CLOUD_VM, EDGE_BOX_1, EDGE_BOX_2,
                                        GTX_1070, RPI4)
from repro_torch.models import cnn_zoo

CACHE_ROOT = os.path.join(os.path.dirname(__file__), "..", "results",
                          "benchdb_torch")

# Calibration.  The reference scales network times by 6 because its host's
# CNN compute is ~6x slower than the paper's cloud box, so the paper's cloud
# time for MobileNetV2 is the reference's TimingProvider time on its CPU
# divided by 6.  The card's factor keeps that ratio: network times scale by
# the card's whole-MobileNetV2 TimingProvider time (speed factor 1) over
# that paper cloud time.  Derived once from the two times below.
#
# The JAX package's TimingProvider time for MobileNetV2 (the sum of its 34
# block times, each divided by its resource's speed factor): the median of
# the 20 such times in four runs of examples/quickstart.py, each with an
# empty cache (73.08-155.73 ms), on an 8-vCPU Intel Xeon host shared with
# other jobs.
CPU_MOBILENETV2_S = 0.11826
# The port's TimingProvider time for MobileNetV2 on the card, the same
# statistic over one run: the median over the five tiers of the sum of the
# block times over the tier's speed factor (0.8190-0.8221 ms), from the
# first run of chip_smoke.py's zoo phase that printed it with block times
# taken as replays of a CUDA graph (its first DB), on an NVIDIA H100 80GB
# HBM3 at a 700.00 W power limit.  It replaces 3.2415 ms, the same
# statistic when blocks were timed as eager calls (2.9460-3.8407 ms over
# the tiers), which held the host's launch work.
CARD_MOBILENETV2_S = 0.0008193
PAPER_TIME_SCALE = 6.0
TIME_SCALE = PAPER_TIME_SCALE * CARD_MOBILENETV2_S / CPU_MOBILENETV2_S

# tier speed ratios calibrated from the paper (Table III overheads and the
# Fig 6-8 end-to-end latencies): device ~8x cloud, edges ~2x, GPU ~0.5x
SPEED = {"device": 8.0, "edge1": 2.1, "edge2": 1.7, "cloud": 1.0,
         "cloud_gpu": 0.5}


def testbed() -> list[Resource]:
    return [
        Resource("device", "device", RPI4, speed_factor=SPEED["device"]),
        Resource("edge1", "edge", EDGE_BOX_1, speed_factor=SPEED["edge1"]),
        Resource("edge2", "edge", EDGE_BOX_2, speed_factor=SPEED["edge2"]),
        Resource("cloud", "cloud", CLOUD_VM, speed_factor=SPEED["cloud"]),
        Resource("cloud_gpu", "cloud", GTX_1070,
                 speed_factor=SPEED["cloud_gpu"]),
    ]


def scaled(link: Link, factor: float = TIME_SCALE) -> Link:
    """``link`` with its latency times ``factor`` and its bandwidth over
    it: every transfer takes ``factor`` times as long."""
    return Link(link.name, link.latency_s * factor, link.bandwidth / factor)


NETWORKS = {"3g": scaled(THREE_G), "4g": scaled(FOUR_G),
            "wired": scaled(WIRED)}


def fp32_flags() -> dict[str, bool]:
    """Turn TF32 off for cuDNN's convolutions and cuBLAS's products, as the
    port's fp32 rule asks, and return the flags as they then stand (cuDNN's
    ``benchmark`` flag is left at its default)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return {"cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
            "cuda.matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32,
            "cudnn.benchmark": torch.backends.cudnn.benchmark}


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def scission_for(network_name: str = "4g",
                 resources: list[Resource] | None = None,
                 device: str | torch.device = "cuda") -> Scission:
    """The five-tier testbed under ``network_name``, timed on ``device``
    with TF32 off."""
    dev = resolve_device(device)
    fp32_flags()
    res = resources if resources is not None else testbed()
    net = paper_network(NETWORKS[network_name],
                        edges=tuple(r.name for r in res if r.tier == "edge"),
                        clouds=tuple(r.name for r in res
                                     if r.tier == "cloud"))
    return Scission(resources=res, network=net, source="device",
                    provider=TimingProvider(device=dev), runs=5, device=dev)


# How TimingProvider times a block on each kind of device: on the card the
# replays of a CUDA graph of the block (device time), elsewhere the
# wall-clock of an eager call.  A cached DB is reused only under the same
# tag, so no DB timed eagerly on the card is read again.
TIMING = {"cuda": "cudagraph", "cpu": "eager", "meta": "eager"}


def fleet_testbed(n_per_tier: int = 9) -> list[Resource]:
    """A fleet-sized resource set: ``n_per_tier`` heterogeneous resources
    per tier (slightly different speed factors), for search spaces beyond
    ``EXHAUSTIVE_LIMIT`` where only the lattice strategies are viable."""
    res: list[Resource] = []
    for i in range(n_per_tier):
        res.append(Resource(f"device{i}", "device", RPI4,
                            speed_factor=8.0 + i * 0.37))
        res.append(Resource(f"edge{i}", "edge", EDGE_BOX_1,
                            speed_factor=1.6 + i * 0.21))
        res.append(Resource(f"cloud{i}", "cloud", CLOUD_VM,
                            speed_factor=0.5 + i * 0.13))
    return res


def fleet_engine(n_per_tier: int = 9, n_blocks: int = 32,
                 network_name: str = "4g",
                 input_bytes: float = 150e3) -> QueryEngine:
    """A QueryEngine over a synthetic ``n_blocks``-block model benchmarked
    (analytically, for speed) on :func:`fleet_testbed`: the fleet-scale
    query-path substrate.  Each layer widens the first feature of its
    input to ``d`` features (``torch.tile``, as the reference's
    ``jnp.tile``), with the reference's seeded widths and FLOPs.  With the
    defaults the search space is ~350k configs, past the exhaustive
    limit."""
    rng = np.random.default_rng(n_blocks)
    layers = []
    for i in range(n_blocks):
        d = int(rng.integers(4, 16)) * 2
        layers.append(LayerNode(
            f"l{i}", "dense",
            apply=lambda x, d=d: torch.tile(x[..., :1], (1, d)),
            flops=float(rng.integers(1, 100)) * 1e7))
    graph = linear_graph(f"fleet{n_blocks}",
                         TensorSpec((1, 8), torch.float32), layers)
    resources = fleet_testbed(n_per_tier)
    db = benchmark_model(graph, resources, AnalyticProvider(), runs=1)
    net = NetworkModel(default=NETWORKS[network_name])
    return QueryEngine(db, resources, net, source="device0",
                       input_bytes=input_bytes)


def cache_dir(device: torch.device) -> str:
    """``results/benchdb_torch/<device name>/<timing method>``."""
    name = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else device.type
    return os.path.join(CACHE_ROOT, re.sub(r"[^A-Za-z0-9.]+", "_", name),
                        TIMING[device.type])


def benchmark_cached(scission: Scission, model_name: str,
                     batch_sizes: tuple[int, ...] = (1,)):
    """Steps 1-3 with a disk cache (the paper's offline benchmarking),
    per device.

    The cache is reused only when it covers the requested resources AND
    batch sizes; otherwise the model is re-benchmarked with the union of
    cached and requested batches, so a batched scenario upgrades the cached
    DB in place.
    """
    directory = cache_dir(scission.device)
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"{model_name}.json")
    want_batches = set(batch_sizes) | {1}
    if os.path.exists(path):
        db = scission.restore(path)
        names = [r.name for r in scission.resources]
        have_resources = set(names) <= set(db.records)
        # coverage over the *active* testbed only: the cache may hold stale
        # records for departed resources at fewer batch sizes
        missing = want_batches - set(db.measured_batches(names))
        if have_resources and not missing:
            return db
        if have_resources:
            graph = cnn_zoo.build(model_name, scission.device)
            db = scission.benchmark_batches(
                graph, batch_sizes=tuple(sorted(missing)))
            scission.save(model_name, path)
            return db
        want_batches |= set(db.measured_batches())
    graph = cnn_zoo.build(model_name, scission.device)
    db = scission.benchmark(graph, batch_sizes=tuple(sorted(want_batches)))
    scission.save(model_name, path)
    return db


def tier_times(db, resources: list[Resource]) -> dict[str, float]:
    """Each tier's whole-model time in a DB: the sum of its block times over
    its speed factor (the calibration's statistic is their median)."""
    return {r.name: sum(b.mean_time_s for b in db.records[r.name])
            / r.speed_factor for r in resources}


def verdict(best) -> str:
    """``"device-native"`` (every block on ``device``), ``"cloud-native"``
    (every block on ``cloud`` or ``cloud_gpu``) or ``"split"``."""
    if best.resources == ("device",):
        return "device-native"
    if set(best.resources) <= {"cloud", "cloud_gpu"}:
        return "cloud-native"
    return "split"


def flips(best_3g, best_4g) -> bool:
    """The paper's headline decision: device-native under 3G, cloud-native
    under 4G."""
    return (verdict(best_3g), verdict(best_4g)) == ("device-native",
                                                    "cloud-native")


def flip_range(db, resources: list[Resource]) -> tuple[float, float]:
    """The network scale factors ``f`` (every transfer ``f`` times as long
    as under ``TIME_SCALE``) at which :func:`flips` holds, from re-queries
    of ``db`` (no re-timing): the edges, by bisection on log f within
    [1/1024, 1024], of the region around the hit nearest f = 1 on a grid of
    powers of 2**(1/4); (nan, nan) where none holds."""
    edges = tuple(r.name for r in resources if r.tier == "edge")
    clouds = tuple(r.name for r in resources if r.tier == "cloud")

    def holds(f):
        best = [QueryEngine(db, resources,
                            paper_network(scaled(link, TIME_SCALE * f),
                                          edges=edges, clouds=clouds),
                            source="device", input_bytes=150e3)
                .run(Query(top_n=1)).best for link in (THREE_G, FOUR_G)]
        return flips(*best)

    hits = [f for f in (2.0 ** (i / 4) for i in range(-40, 41)) if holds(f)]
    if not hits:
        return math.nan, math.nan
    mid = min(hits, key=lambda f: abs(math.log(f)))

    def edge(inside, outside):
        for _ in range(12):
            m = math.sqrt(inside * outside)
            inside, outside = (m, outside) if holds(m) else (inside, m)
        return inside

    return edge(mid, 2.0 ** -10), edge(mid, 2.0 ** 10)
