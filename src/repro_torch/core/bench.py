"""Benchmarking harness (Scission §II-C Steps 2-3).

Each block is split into a standalone sub-model (with its own input layer)
and benchmarked ``runs`` times on every target resource; the mean execution
time and the output size are recorded in a :class:`BenchmarkDB`.

Measurements are **batch-indexed**: every (block, resource) record carries a
``batch_profile`` mapping batch size to (mean seconds per batch, output
bytes per batch).  One request per stage is just the ``batch == 1`` point;
the partitioner's throughput model reads the profile to price batched and
replicated stages.  Unmeasured batch sizes are answered by log-linear
interpolation between measured points, clamped to the measured range (never
extrapolated).

Three providers implement the paper's "empirical, not estimated" principle:

* :class:`TimingProvider` — the block's time on one device (the card, by
  default: replays of a captured CUDA graph), scaled by the resource's
  ``speed_factor``.  This is the
  **paper-faithful** path (the measuring device plays the 'Cloud' box; the
  paper itself emulates the other tiers' network conditions the same way).
* :class:`CompiledCostProvider` — the FLOPs and bytes the block's operators
  count on ``meta`` tensors, through the DeviceModel.
* :class:`AnalyticProvider` — the graph's analytic per-layer FLOPs through
  the DeviceModel.  Cheapest; used for very large models and in tests.
"""

from __future__ import annotations

import bisect
import inspect
import json
import math
import statistics
import time
from dataclasses import dataclass, asdict, field
from typing import Any, Protocol

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from .._device import replay_seconds, resolve_device, synchronize
from ..kernels.substrate import KernelAutotuner
from .graph import Block, LayerGraph, TensorSpec, fuse_blocks
from .resources import Resource

# JSON schema history:
#   1 — one scalar (mean_time_s, output_bytes) per (block, resource);
#       implicit (no "schema_version" key in the payload).
#   2 — adds ``batch_profile`` {batch: [mean_s, output_bytes]} per record.
# ``from_json`` migrates v1 payloads by promoting the scalars to a batch-1
# profile, so persisted results/ DBs keep loading unchanged.
SCHEMA_VERSION = 2


def _interp_profile(profile: dict[int, tuple[float, float]], batch: int,
                    index: int = 0) -> float:
    """Log-linear interpolation of a batch profile at ``batch``.

    ``index`` selects the profile component (0 = mean seconds, 1 = output
    bytes).  Queries outside the measured range clamp to the nearest
    measured batch — the cost model never extrapolates beyond what was
    benchmarked.  Interpolation is linear in (log batch, log value) space,
    which keeps values positive and preserves monotonicity of the measured
    profile.
    """
    if not profile:
        raise KeyError("empty batch profile")
    if batch in profile:
        return float(profile[batch][index])
    bs = sorted(profile)
    if batch <= bs[0]:
        return float(profile[bs[0]][index])
    if batch >= bs[-1]:
        return float(profile[bs[-1]][index])
    hi = bisect.bisect_left(bs, batch)
    b0, b1 = bs[hi - 1], bs[hi]
    v0 = float(profile[b0][index])
    v1 = float(profile[b1][index])
    u = (math.log(batch) - math.log(b0)) / (math.log(b1) - math.log(b0))
    if v0 > 0.0 and v1 > 0.0:
        return math.exp((1.0 - u) * math.log(v0) + u * math.log(v1))
    return (1.0 - u) * v0 + u * v1        # degenerate zero values


@dataclass
class BlockBenchmark:
    """One (block, resource) measurement — the paper's Step 3 record.

    ``mean_time_s`` / ``output_bytes`` are the batch-1 scalars (the paper's
    one-request-per-stage view); ``batch_profile`` holds the full sweep
    ``{batch_size: (mean_s_per_batch, output_bytes_per_batch)}``.
    ``tuned_params`` records the autotuned block sizes (per kernel node)
    the measurement was taken with, so a persisted DB documents exactly
    which kernel configuration its timings describe.
    """

    block: int
    resource: str
    mean_time_s: float
    std_time_s: float
    output_bytes: int
    runs: int
    flops: float = 0.0
    bytes_accessed: float = 0.0
    tuned_params: dict = field(default_factory=dict)
    batch_profile: dict[int, tuple[float, int]] = field(default_factory=dict)

    def __post_init__(self):
        if not self.batch_profile:
            self.batch_profile = {1: (self.mean_time_s, self.output_bytes)}

    def time_at(self, batch: int) -> float:
        """Mean seconds per batch at ``batch``, interpolated (clamped)."""
        return _interp_profile(self.batch_profile, batch, index=0)

    def output_bytes_at(self, batch: int) -> int:
        """Bytes crossing the cut per batch at ``batch``."""
        if batch in self.batch_profile:
            return int(self.batch_profile[batch][1])
        # activations scale linearly with batch; derive from the smallest
        # measured batch rather than log-interpolating an exactly-linear
        # quantity
        b0 = min(self.batch_profile)
        return int(round(self.batch_profile[b0][1] / b0 * batch))


@dataclass
class BenchmarkDB:
    """All measurements for one model: ``times[resource][block]``.

    The query engine (Step 6) operates exclusively on this structure, which
    is what makes queries fast (<50 ms): re-querying never re-benchmarks.
    """

    model: str
    n_blocks: int
    records: dict[str, list[BlockBenchmark]] = field(default_factory=dict)
    # batch-clamp diagnostics (SCN111) accumulated by time() queries outside
    # the measured profile range, drained by the query engine onto
    # QueryResult.diagnostics; bookkeeping only, not part of the DB's value
    _pending_diags: list = field(default_factory=list, repr=False,
                                 compare=False)
    _noted_clamps: set = field(default_factory=set, repr=False, compare=False)

    def time(self, resource: str, block: int, batch: int = 1) -> float:
        """Mean seconds per batch for ``block`` on ``resource`` at ``batch``.

        Unmeasured batch sizes interpolate log-linearly between measured
        profile points and clamp at the measured extremes — and a clamped
        query is *recorded* (SCN111 warning, drained via
        :meth:`drain_diagnostics`) rather than silently answered with the
        nearest measured batch's time.
        """
        rec = self.records[resource][block]
        if batch == 1:
            return rec.mean_time_s
        lo, hi = min(rec.batch_profile), max(rec.batch_profile)
        if not lo <= batch <= hi:
            self._note_clamp(resource, batch, lo, hi)
        return rec.time_at(batch)

    def _note_clamp(self, resource: str, batch: int, lo: int, hi: int):
        if (resource, batch) in self._noted_clamps:
            return
        self._noted_clamps.add((resource, batch))
        from ..analysis.diagnostics import Diagnostic, WARNING
        self._pending_diags.append(Diagnostic(
            "SCN111", WARNING,
            f"batch size {batch} on {resource!r} is outside the measured "
            f"profile range [{lo}, {hi}]; times were clamped to the "
            f"nearest measured batch", subject=resource,
            hint=f"re-run benchmark_model(batch_sizes=(..., {batch})) to "
                 "measure it"))

    def drain_diagnostics(self) -> list:
        """Hand off (and clear) the accumulated clamp diagnostics — the
        query engine attaches them to the ``QueryResult`` whose pricing
        triggered them."""
        out, self._pending_diags = self._pending_diags, []
        self._noted_clamps.clear()
        return out

    def output_bytes(self, block: int, batch: int = 1) -> int:
        if not self.records:
            raise KeyError(
                f"BenchmarkDB for model {self.model!r} has no records; "
                "run benchmark_model() (Steps 2-3) before querying sizes")
        some = next(iter(self.records.values()))
        if batch == 1:
            return some[block].output_bytes
        return some[block].output_bytes_at(batch)

    def measured_batches(self, resources: list[str] | None = None
                         ) -> list[int]:
        """Sorted batch sizes measured for every (resource, block) record —
        the operating points a frontier sweep can price exactly.

        ``resources`` restricts the intersection to those records: a DB may
        carry stale records for departed resources at fewer batch sizes,
        and they must not mask batches the active testbed did measure.
        """
        common: set[int] | None = None
        for name, recs in self.records.items():
            if resources is not None and name not in resources:
                continue
            for rec in recs:
                bs = set(rec.batch_profile)
                common = bs if common is None else common & bs
        return sorted(common or {1})

    def max_batch(self, resources: list[str] | None = None) -> int:
        batches = self.measured_batches(resources)
        return batches[-1] if batches else 1

    def times_matrix(self, resources: list[str],
                     batch: int = 1) -> np.ndarray:
        """(R, B) matrix of mean per-batch block times — the vectorised form
        used by the partition enumerator."""
        return np.array([[self.time(r, b.block, batch)
                          for b in self.records[r]]
                         for r in resources])

    def out_bytes_vector(self, batch: int = 1) -> np.ndarray:
        return np.array(
            [self.output_bytes(i, batch) for i in range(self.n_blocks)],
            dtype=np.float64)

    # -- (de)serialisation so benchmarking is a strictly offline step --------
    def to_json(self) -> str:
        def rec(b: BlockBenchmark) -> dict:
            d = asdict(b)
            # JSON object keys are strings; values as 2-lists
            d["batch_profile"] = {str(k): [v[0], v[1]]
                                  for k, v in b.batch_profile.items()}
            return d

        return json.dumps({
            "schema_version": SCHEMA_VERSION,
            "model": self.model,
            "n_blocks": self.n_blocks,
            "records": {r: [rec(b) for b in bs]
                        for r, bs in self.records.items()},
        })

    @classmethod
    def from_json(cls, s: str) -> "BenchmarkDB":
        d = json.loads(s)
        version = d.get("schema_version", 1)
        if version > SCHEMA_VERSION:
            raise ValueError(
                f"BenchmarkDB schema_version {version} is newer than this "
                f"code understands ({SCHEMA_VERSION}); upgrade the loader")

        def rec(b: dict) -> BlockBenchmark:
            profile = b.pop("batch_profile", None)
            out = BlockBenchmark(**b)
            if profile:                      # v2 payload
                out.batch_profile = {
                    int(k): (float(v[0]), int(v[1]))
                    for k, v in profile.items()}
            # v1 payloads fall through to __post_init__'s batch-1 profile
            return out

        db = cls(model=d["model"], n_blocks=d["n_blocks"])
        db.records = {r: [rec(dict(b)) for b in bs]
                      for r, bs in d["records"].items()}
        return db


class BenchmarkProvider(Protocol):
    def measure(self, block: Block, resource: Resource, runs: int,
                batch: int = 1) -> tuple[float, float, float, float]:
        """Returns (mean_s, std_s, flops, bytes_accessed) for one batch of
        ``batch`` requests."""


def _batched_input(spec: TensorSpec, batch: int) -> TensorSpec:
    """The block's input spec replicated ``batch`` times along axis 0 (every
    graph in this repo traces with a leading batch axis)."""
    if batch == 1:
        return spec
    return TensorSpec((spec.shape[0] * batch, *spec.shape[1:]), spec.dtype)


class TimingProvider:
    """Measured time of the block's sub-model on ``device``.

    Faithful to the paper: ``runs`` runs, averaged, after one warm-up run,
    on real inputs of the block's input shape.  On the card, as the
    reference times ``jax.jit`` of the block with one dispatch per sample,
    one call is captured in a CUDA graph after the warm-up and each sample
    is one replay between CUDA events (``_device.replay_seconds``): the
    block's device time, without the host's per-operator launch work.  A
    block that cannot be captured raises.  On the CPU a sample is the
    wall-clock of one eager call.  Batched measurements feed a batch-``b``
    input through the same sub-model, so economies of scale are captured
    empirically.

    When constructed with a :class:`KernelAutotuner`, kernel-bearing layers
    are block-size-tuned (per resource) before timing, so the DB records
    tuned rather than default kernel timings.
    """

    def __init__(self, tuner: KernelAutotuner | None = None,
                 device: str | torch.device = "cuda"):
        self.tuner = tuner
        self.device = resolve_device(device)

    def measure(self, block: Block, resource: Resource, runs: int,
                batch: int = 1) -> tuple[float, float, float, float]:
        if self.tuner is not None:
            self.tuner.tune_block(block, resource=resource.name)
        fn = block.make_callable()
        # one input per entry tensor — a join block of a branchy graph has
        # several; chain blocks degenerate to the single-input call
        xs = []
        for s in block.in_specs:
            spec = _batched_input(s, batch)
            xs.append(torch.zeros(spec.shape, dtype=spec.dtype,
                                  device=self.device))
        fn(*xs)  # warm-up
        synchronize(self.device)
        if self.device.type == "cuda":
            samples = replay_seconds(fn, tuple(xs), runs, self.device)
        else:
            samples = []
            for _ in range(runs):
                t0 = time.perf_counter()
                fn(*xs)
                synchronize(self.device)
                samples.append(time.perf_counter() - t0)
        mean = statistics.fmean(samples) * resource.speed_factor
        std = (statistics.pstdev(samples) if len(samples) > 1 else 0.0)
        return mean, std * resource.speed_factor, 0.0, 0.0


class _BytesAccessed(TorchDispatchMode):
    """Sums the bytes of every operator's tensor inputs and outputs, as
    XLA's "bytes accessed" counts an operation's operands and results, but
    per unfused eager operator: an in-place activation reads and writes its
    tensor again, and an explicit pad is a copy.  View operators move
    nothing and are skipped.  So is a copy onto another device: run on
    ``meta`` inputs, such a copy only makes the ``meta`` stand-in of a
    weight that lives on the card or the CPU, and the weight is counted
    where an operator reads it."""

    def __init__(self):
        super().__init__()
        self.nbytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.count(func, args, kwargs, out)
        return out

    def count(self, func, args, kwargs, out):
        """Add the bytes of one operator's inputs and outputs."""
        moved = func is torch.ops.aten._to_copy.default and \
            args[0].device != out.device
        if not func.is_view and not moved:
            for t in tree_flatten((args, kwargs, out))[0]:
                if isinstance(t, torch.Tensor):
                    self.nbytes += t.numel() * t.element_size()


class CompiledCostProvider:
    """FLOPs and bytes of the block's operators, through the device
    roofline.

    The counterpart of the reference's compiled-artifact costs: the block
    runs once on ``meta`` tensors at the requested batch (no data, no
    device), ``torch.utils.flop_counter.FlopCounterMode`` counts its FLOPs
    and every eager operator's inputs and outputs are counted as bytes
    accessed (:class:`_BytesAccessed`), the same wherever the block's
    weights live.  Both go through the resource's ``DeviceModel.layer_time``.
    """

    def __init__(self, tuner: KernelAutotuner | None = None):
        self.tuner = tuner

    def measure(self, block: Block, resource: Resource, runs: int,
                batch: int = 1) -> tuple[float, float, float, float]:
        if self.tuner is not None:
            self.tuner.tune_block(block, resource=resource.name)
        specs = [_batched_input(s, batch) for s in block.in_specs]
        xs = [torch.empty(s.shape, dtype=s.dtype, device="meta")
              for s in specs]
        counter = _BytesAccessed()
        with FlopCounterMode(display=False) as flop_mode, counter:
            block.make_callable()(*xs)
        flops = float(flop_mode.get_total_flops())
        nbytes = float(counter.nbytes)
        t = resource.device.layer_time(flops, nbytes)
        return t, 0.0, flops, nbytes


class AnalyticProvider:
    """Graph-declared FLOPs through the device roofline (no compilation).

    Batch scaling: FLOPs and activation traffic scale linearly with batch,
    parameters are read once per batch — so per-request time improves with
    batch until the roofline binds (dispatch overhead and parameter reads
    amortise), the analytic analogue of what wall-clock batching measures.
    """

    def measure(self, block: Block, resource: Resource, runs: int,
                batch: int = 1) -> tuple[float, float, float, float]:
        flops = block.flops * batch
        # memory traffic ~ params once + activations in/out per request
        # (every entry tensor of a multi-entry join block is read)
        in_bytes = sum(s.nbytes for s in block.in_specs)
        nbytes = block.param_bytes + (in_bytes + block.output_bytes) * batch
        t = resource.device.layer_time(flops, nbytes)
        return t, 0.0, flops, float(nbytes)


def _accepts_batch(provider: BenchmarkProvider) -> bool:
    try:
        params = inspect.signature(provider.measure).parameters
    except (TypeError, ValueError):
        return True
    return "batch" in params or any(
        p.kind is inspect.Parameter.VAR_KEYWORD for p in params.values())


def _measure(provider: BenchmarkProvider, block: Block, resource: Resource,
             runs: int, batch: int) -> tuple[float, float, float, float]:
    if _accepts_batch(provider):
        return provider.measure(block, resource, runs, batch=batch)
    # pre-batch provider: only the paper's batch-1 point is measurable
    if batch != 1:
        raise TypeError(
            f"provider {type(provider).__name__} does not accept batch= — "
            "it cannot measure a batch-size sweep")
    return provider.measure(block, resource, runs)


def benchmark_model(graph: LayerGraph, resources: list[Resource],
                    provider: BenchmarkProvider | None = None,
                    runs: int = 5,
                    blocks: list[Block] | None = None,
                    batch_sizes: tuple[int, ...] = (1,)) -> BenchmarkDB:
    """Steps 2-3: fuse into blocks, benchmark every block on every resource
    at every requested batch size.

    ``batch_sizes`` always includes 1 (the paper's one-request-per-stage
    point and the scalar view every legacy consumer reads); pass e.g.
    ``(1, 4, 16)`` to record a profile the throughput model can interpolate.
    """
    provider = provider or TimingProvider()
    blocks = blocks if blocks is not None else fuse_blocks(graph)
    batches = sorted({int(b) for b in batch_sizes} | {1})
    if any(b < 1 for b in batches):
        raise ValueError(f"batch sizes must be >= 1, got {batch_sizes}")
    db = BenchmarkDB(model=graph.name, n_blocks=len(blocks))
    tuner = getattr(provider, "tuner", None)
    for res in resources:
        recs = []
        for blk in blocks:
            profile: dict[int, tuple[float, int]] = {}
            mean1 = std1 = flops1 = nbytes1 = 0.0
            for b in batches:
                mean, std, flops, nbytes = _measure(provider, blk, res,
                                                    runs, b)
                profile[b] = (mean, blk.output_bytes * b)
                if b == 1:
                    mean1, std1, flops1, nbytes1 = mean, std, flops, nbytes
            tuned = tuner.params_for_block(blk) if tuner is not None else {}
            recs.append(BlockBenchmark(
                block=blk.index, resource=res.name, mean_time_s=mean1,
                std_time_s=std1, output_bytes=blk.output_bytes, runs=runs,
                flops=flops1, bytes_accessed=nbytes1, tuned_params=tuned,
                batch_profile=profile))
        db.records[res.name] = recs
    return db


def benchmark_batches(db: BenchmarkDB, graph: LayerGraph,
                      resources: list[Resource],
                      provider: BenchmarkProvider | None = None,
                      runs: int = 5,
                      batch_sizes: tuple[int, ...] = (),
                      blocks: list[Block] | None = None) -> BenchmarkDB:
    """Incremental Step 3 over *batch sizes*: measure only the batches not
    already in ``db``'s profiles and merge them in place — the batch-axis
    companion of :meth:`Scission.benchmark_resource`'s resource-axis
    incrementality.  Existing measurements (including the batch-1 scalars)
    are never re-timed, so upgrading a cached DB with new operating points
    neither repeats the old sweep nor perturbs its decision geometry.

    Every resource must already have records in ``db`` (benchmark it first).
    """
    provider = provider or TimingProvider()
    batches = sorted({int(b) for b in batch_sizes})
    if any(b < 1 for b in batches):
        raise ValueError(f"batch sizes must be >= 1, got {batch_sizes}")
    blocks = blocks if blocks is not None else fuse_blocks(graph)
    for res in resources:
        recs = db.records.get(res.name)
        if recs is None:
            raise KeyError(
                f"resource {res.name!r} has no records in the DB for model "
                f"{db.model!r}; run benchmark_model for it before adding "
                "batch sizes incrementally")
        for blk, rec in zip(blocks, recs):
            for b in batches:
                if b in rec.batch_profile:
                    continue
                mean, _, _, _ = _measure(provider, blk, res, runs, b)
                rec.batch_profile[b] = (mean, blk.output_bytes * b)
    return db
