"""Substrate under the hand-written Hopper kernels.

* **Pad helpers** — :func:`round_up` / :func:`pad_axis_to`, used by the
  plain PyTorch versions, which pad uneven sequence lengths to the next
  block boundary exactly as the TPU kernels do (the CUDA kernels mask the
  ragged edge themselves and need no padded copy).
* **Kernel forward, plain backward** — :class:`KernelFunction`, the
  autograd Function through which a kernel with no backward of its own
  trains.
* **Block-size autotuner** — :class:`KernelAutotuner` sweeps
  ``(block_q, block_k)`` / ``block_k`` / ``chunk`` candidates per (kernel,
  shape, resource), caches the winner, and rewrites tunable graph nodes in
  place so the benchmark providers measure *tuned* kernel timings.  Winners are
  carried into ``BenchmarkDB`` records (``BlockBenchmark.tuned_params``),
  which is what the partition/query engines consume.

Where the TPU autotuner pruned candidates against a VMEM budget, this one
prunes against the card's shared memory per block: a candidate whose tile
footprint (``analysis.kernel_smem.lint_candidates``) exceeds the limit is
recorded in ``TuneRecord.pruned`` with its byte count and never launched.
With ``tile_check`` a candidate misaligned to the Hopper kernels' tiles, or
one the launch would refuse (``analysis.tiling``), is recorded in
``TuneRecord.tile_pruned`` with the reason and never launched either.  A
failing launch is not caught: a CUDA fault leaves a sticky error that would
poison every later measurement, so it propagates.
"""

from __future__ import annotations

import functools
import json
import math
import time
from dataclasses import dataclass, field, asdict
from typing import Callable

import torch
import torch.nn.functional as F

from .. import tracing
from .._device import replay_seconds, resolve_device, synchronize


def round_up(n: int, multiple: int) -> int:
    if multiple <= 0:
        raise ValueError(f"multiple must be positive, got {multiple}")
    return ((n + multiple - 1) // multiple) * multiple


def pad_axis_to(x: torch.Tensor, axis: int, target: int) -> torch.Tensor:
    """Zero-pad ``x`` along ``axis`` up to length ``target`` (no-op when
    already there)."""
    size = x.shape[axis]
    if size == target:
        return x
    if size > target:
        raise ValueError(f"cannot pad axis {axis} from {size} down to {target}")
    axis %= x.ndim
    # F.pad lists (left, right) pairs from the last axis backwards
    pads = [0, 0] * (x.ndim - 1 - axis) + [0, target - size]
    return F.pad(x, pads)


class KernelFunction(torch.autograd.Function):
    """The kernel forward, the plain version's gradient backward:
    ``apply(name, launch, plain, *inputs)``, where ``launch`` and ``plain``
    take the tensor inputs alone and give the same outputs.  The backward
    recomputes ``plain`` from the saved inputs under a
    ``kernel.<name>.backward`` span (CUDA events on the card),
    differentiates the outputs that received a gradient (an input that
    takes no part in them gets None) and counts
    ``<name>_backward_launches``."""

    @staticmethod
    def forward(ctx, name, launch, plain, *inputs):
        ctx.save_for_backward(*inputs)
        ctx.name, ctx.plain = name, plain
        ctx.set_materialize_grads(False)
        return launch(*inputs)

    @staticmethod
    def backward(ctx, *grads):
        inputs = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with tracing.span(f"kernel.{ctx.name}.backward",
                          device=inputs[0].is_cuda), torch.enable_grad():
            outs = ctx.plain(*inputs)
            if not isinstance(outs, tuple):
                outs = (outs,)
            pairs = [(o, g) for o, g in zip(outs, grads) if g is not None]
            got = torch.autograd.grad([o for o, _ in pairs], inputs,
                                      [g for _, g in pairs],
                                      allow_unused=True)
        tracing.count(f"{ctx.name}_backward_launches")
        return (None, None, None, *got)


# ---------------------------------------------------------------------------
# block-size autotuner
# ---------------------------------------------------------------------------

# Candidate sweeps per kernel.  Defaults (the kernels' keyword defaults) are
# always included so "tuned == default" is an observable outcome.
DEFAULT_CANDIDATES: dict[str, list[dict[str, int]]] = {
    "flash_attention": [{"block_q": bq, "block_k": bk}
                        for bq in (64, 128, 256)
                        for bk in (64, 128, 256)],
    "decode_attention": [{"block_k": bk} for bk in (128, 256, 512)],
    "ssd_scan": [{"chunk": c} for c in (32, 64, 128, 256)],
}

# A candidate displaces the default block sizes only when it is faster by
# more than this fraction.  Two fresh DBs of MobileNetV2 timed as CUDA-graph
# replays lie up to 1% apart (H100 80GB HBM3, 700.00 W, chip_smoke.py),
# while flash attention's default and its nearest candidate at zamba2's
# widths lie 0.1% apart: without the margin the winner would change from
# run to run on noise alone.
TOLERANCE = 0.01

DEFAULT_PARAMS: dict[str, dict[str, int]] = {
    "flash_attention": {"block_q": 128, "block_k": 128},
    "decode_attention": {"block_k": 256},
    "ssd_scan": {"chunk": 128},
}


@dataclass
class TuneRecord:
    """Outcome of one (kernel, shape, resource) sweep.

    The JSON fields are the TPU autotuner's.  ``pruned`` and ``vmem_limit``
    keep their names but hold the card's shared-memory footprints and
    per-block limit in bytes; ``tile_pruned`` holds the reasons of the
    candidates the Hopper tiling analysis pruned.
    """

    kernel: str
    shape_key: str
    resource: str
    params: dict[str, int]            # winning block sizes
    time_s: float                     # winner's measured time
    default_params: dict[str, int]
    default_time_s: float             # NaN when the default was pruned
    trials: dict[str, float] = field(default_factory=dict)  # json(params) -> s
    # candidates pruned before timing: json(params) -> shared-memory bytes
    pruned: dict[str, float] = field(default_factory=dict)
    vmem_limit: float | None = None   # the shared-memory limit of the sweep
    # candidates misaligned or refused, pruned before timing: json -> reason
    tile_pruned: dict[str, str] = field(default_factory=dict)

    @property
    def changed_default(self) -> bool:
        return self.params != self.default_params

    @property
    def speedup_vs_default(self) -> float:
        if not self.time_s or math.isnan(self.default_time_s):
            return 1.0
        return self.default_time_s / self.time_s


def _shape_key(args) -> str:
    """``float32[1, 96, 2, 32]``: numpy's dtype names, as the TPU tuner's."""
    return "x".join(f"{str(a.dtype).removeprefix('torch.')}{list(a.shape)}"
                    for a in args)


def card_smem_limit(device: torch.device) -> int | None:
    """Shared memory one block may opt in to on ``device`` (None off the
    card, where the plain versions run and nothing limits a tile); read
    once per card."""
    if device.type != "cuda":
        return None
    index = device.index
    if index is None:
        index = torch.cuda.current_device()
    return _smem_optin(index)


@functools.lru_cache(maxsize=None)
def _smem_optin(index: int) -> int:
    return int(torch.cuda.get_device_properties(index)
               .shared_memory_per_block_optin)


class KernelAutotuner:
    """Sweeps block-size candidates and caches per-(kernel, shape, resource)
    winners.

    ``tune`` measures a candidate callable (min over ``runs`` after a
    warm-up) as ``TimingProvider`` measures a block: on the card each
    sample is one replay of the candidate captured in a CUDA graph, timed
    by CUDA events, as the reference times ``jax.jit`` candidates; on the
    CPU the wall-clock of one eager call.  A custom
    ``measure`` hook replaces the timing (unit tests).  On the card,
    candidates over the per-block shared-memory limit are pruned before any
    launch; ``smem_limit`` overrides the limit read from the card.  With
    ``tile_check`` (the default) candidates misaligned to the kernels' tiles
    or refused by their launch are pruned before timing too, unless that
    would empty the sweep.  The default block sizes win unless a candidate
    is faster by more than ``TOLERANCE`` (the reference takes the fastest
    outright).
    """

    def __init__(self, candidates: dict[str, list[dict[str, int]]] | None = None,
                 runs: int = 2,
                 measure: Callable[[Callable, tuple], float] | None = None,
                 smem_limit: int | None = None,
                 device: str | torch.device = "cuda",
                 tile_check: bool = True):
        self.device = resolve_device(device)
        self.candidates = dict(DEFAULT_CANDIDATES)
        if candidates:
            self.candidates.update(candidates)
        self.runs = runs
        self.measure = measure
        self.smem_limit = (smem_limit if smem_limit is not None
                           else card_smem_limit(self.device))
        self.tile_check = tile_check
        self.records: dict[tuple[str, str, str], TuneRecord] = {}
        # Measurements are taken on one device and are independent of the
        # emulated resource (speed factors scale uniformly), so trial tables
        # are shared across resources; each resource still gets its record.
        self._trials: dict[tuple[str, str], dict[str, float]] = {}

    # -- measurement --------------------------------------------------------
    def _time_candidate(self, fn: Callable, args: tuple) -> float:
        if self.measure is not None:
            return self.measure(fn, args)
        fn(*args)                       # warm-up
        synchronize(self.device)
        if self.device.type == "cuda":
            return min(replay_seconds(fn, args, max(1, self.runs),
                                      self.device))
        best = float("inf")
        for _ in range(max(1, self.runs)):
            t0 = time.perf_counter()
            fn(*args)
            synchronize(self.device)
            best = min(best, time.perf_counter() - t0)
        return best

    # -- core sweep ---------------------------------------------------------
    def tune(self, kernel: str, factory: Callable[[dict[str, int]], Callable],
             args: tuple, *, resource: str = "host",
             defaults: dict[str, int] | None = None,
             shape_key: str | None = None,
             config_key: str = "",
             options: dict | None = None) -> TuneRecord:
        """Sweep candidates for ``kernel`` at the shapes of ``args``.

        ``factory(params)`` returns the callable to measure.  ``config_key``
        distinguishes factories whose behaviour differs beyond the argument
        shapes (causal/window/softcap, ...); ``options`` are the node's
        ``kernel_options``, which the shared-memory footprint reads for
        dimensions the args don't expose.  The winning record is cached per
        (kernel, shape+config, resource), and the trial table is shared
        across resources.
        """
        defaults = dict(defaults or DEFAULT_PARAMS.get(kernel, {}))
        shape_key = shape_key or _shape_key(args)
        if config_key:
            shape_key = f"{shape_key}|{config_key}"
        key = (kernel, shape_key, resource)
        if key in self.records:
            return self.records[key]

        candidates = list(self.candidates.get(kernel, []))
        if defaults and defaults not in candidates:
            candidates.insert(0, defaults)
        if not candidates:
            candidates = [defaults]

        pruned: dict[str, float] = {}
        kept = candidates
        if self.smem_limit is not None:
            from ..analysis.kernel_smem import lint_candidates  # lazy: cycle
            kept, pruned_b, _ = lint_candidates(
                kernel, candidates, args, self.smem_limit, options)
            pruned = {k: float(v) for k, v in pruned_b.items()}
            if not kept:
                sizes = "; ".join(f"{k} -> {v:.0f}B"
                                  for k, v in sorted(pruned.items()))
                raise RuntimeError(
                    f"autotune: every candidate of {kernel} {shape_key} "
                    f"exceeds the {self.smem_limit}B shared-memory limit: "
                    f"{sizes}")

        tile_pruned: dict[str, str] = {}
        if self.tile_check:
            from ..analysis.tiling import misaligned_candidates
            flagged = misaligned_candidates(kernel, kept, args, options)
            aligned = [p for p in kept
                       if json.dumps(p, sort_keys=True) not in flagged]
            # the analysis narrows a sweep but never empties it: with no
            # admissible candidate left, the flagged ones are timed (and a
            # refused one raises at its launch)
            if aligned and flagged:
                kept, tile_pruned = aligned, flagged

        trials = self._trials.setdefault((kernel, shape_key), {})
        for params in kept:
            pkey = json.dumps(params, sort_keys=True)
            if pkey not in trials:
                trials[pkey] = self._time_candidate(factory(params), args)

        kept_keys = {json.dumps(p, sort_keys=True) for p in kept}
        admissible = {k: t for k, t in trials.items() if k in kept_keys}
        best_key = min(admissible, key=admissible.get)
        dkey = json.dumps(defaults, sort_keys=True)
        if dkey in admissible and \
                admissible[dkey] <= admissible[best_key] * (1.0 + TOLERANCE):
            best_key = dkey
        rec = TuneRecord(kernel=kernel, shape_key=shape_key, resource=resource,
                         params=json.loads(best_key),
                         time_s=admissible[best_key],
                         default_params=defaults,
                         default_time_s=admissible.get(dkey, float("nan")),
                         trials=admissible, pruned=pruned,
                         vmem_limit=(float(self.smem_limit)
                                     if self.smem_limit is not None else None),
                         tile_pruned=tile_pruned)
        self.records[key] = rec
        return rec

    # -- graph integration --------------------------------------------------
    def tune_node(self, node, resource: str = "host",
                  in_specs=None) -> TuneRecord | None:
        """Tune one kernel-bearing ``LayerNode`` in place.

        Nodes opt in by carrying ``kernel``, ``kernel_factory`` (params ->
        apply callable) and optionally ``kernel_params`` (defaults).
        ``in_specs`` are the node's input ``TensorSpec`` s (``tune_block``
        derives them from the graph).  The node's ``apply`` is rewritten to
        the tuned callable, so any provider measuring the node afterwards
        measures tuned timings.
        """
        kernel = getattr(node, "kernel", None)
        factory = getattr(node, "kernel_factory", None)
        if not kernel or factory is None:
            return None
        args = tuple(torch.zeros(s.shape, dtype=s.dtype, device=self.device)
                     for s in (in_specs or []))
        if not args:
            return None
        options = getattr(node, "kernel_options", None)
        rec = self.tune(kernel, factory, args, resource=resource,
                        defaults=getattr(node, "kernel_defaults", None)
                        or DEFAULT_PARAMS.get(kernel),
                        config_key=json.dumps(options, sort_keys=True,
                                              default=str)
                        if options else "",
                        options=options)
        node.kernel_params = dict(rec.params)
        node.apply = factory(rec.params)
        return rec

    def tune_block(self, block, resource: str = "host") -> list[TuneRecord]:
        """Tune every kernel node of a fused block (providers call this right
        before measuring the block)."""
        out = []
        g = block.graph
        for i in block.node_ids:
            node = g.nodes[i]
            if getattr(node, "kernel", None) and \
                    getattr(node, "kernel_factory", None) is not None:
                specs = [g.nodes[p].out_spec for p in g.preds[i]]
                rec = self.tune_node(node, resource=resource, in_specs=specs)
                if rec is not None:
                    out.append(rec)
        return out

    def params_for_block(self, block) -> dict[str, dict[str, int]]:
        """Winning block sizes per kernel node of ``block`` (for embedding
        into ``BlockBenchmark.tuned_params``)."""
        out: dict[str, dict[str, int]] = {}
        for i in block.node_ids:
            node = block.graph.nodes[i]
            if getattr(node, "kernel", None) and \
                    getattr(node, "kernel_params", None):
                out[node.name] = dict(node.kernel_params)
        return out

    # -- persistence --------------------------------------------------------
    def to_json(self) -> str:
        return json.dumps([asdict(r) for r in self.records.values()])

    @classmethod
    def from_json(cls, s: str, device: str | torch.device = "cuda"
                  ) -> "KernelAutotuner":
        tuner = cls(device=device)
        for d in json.loads(s):
            rec = TuneRecord(**d)
            tuner.records[(rec.kernel, rec.shape_key, rec.resource)] = rec
        return tuner


# ---------------------------------------------------------------------------
# serving-time tuned-params registry
# ---------------------------------------------------------------------------
# A tuned BenchmarkDB documents the block sizes its timings were measured
# with (``BlockBenchmark.tuned_params``).  Adopting it here makes those
# winners the process-wide serving defaults, so the LM layers
# (``models/layers.py`` attention, ``models/ssm.py`` SSD) launch the kernels
# with the configuration the cost model priced: flash_attention's
# (block_q, block_k), decode_attention's block_k and ssd_scan's chunk.

_SERVING_PARAMS: dict[str, dict[str, int]] = {}

def kernel_for_params(params: dict) -> str | None:
    """Map a tuned-params dict to the kernel it configures by exact
    parameter-name match ({block_q, block_k} -> flash_attention, ...).
    ``BlockBenchmark.tuned_params`` is keyed by node name, not kernel, so
    adoption needs this reverse lookup."""
    keys = frozenset(params)
    for kernel, defaults in DEFAULT_PARAMS.items():
        if keys == frozenset(defaults):
            return kernel
    return None


def adopt_tuned_params(db, *, dtype="float32") -> dict[str, dict[str, int]]:
    """Adopt a BenchmarkDB's tuned winners as serving defaults.

    Walks every record's ``tuned_params`` in deterministic order (sorted
    resources, blocks in order, sorted node names; later entries win),
    rejects a candidate whose values are not positive integers or that the
    Hopper kernel's route for ``dtype`` would pad
    (``analysis.tiling.misaligned_params``: bf16 flash ``block_q`` a
    multiple of 32 and ``block_k`` of 64, bf16 decode ``block_k`` of 64,
    bf16 SSD ``chunk`` of 16; the fp32 routes take any size), and installs
    the survivors.  Returns the adopted ``{kernel: params}`` mapping."""
    from ..analysis.tiling import misaligned_params  # lazy: cycle
    adopted: dict[str, dict[str, int]] = {}
    records = getattr(db, "records", {})
    for rname in sorted(records):
        for rec in records[rname]:
            tuned = getattr(rec, "tuned_params", None) or {}
            for node in sorted(tuned):
                params = dict(tuned[node])
                kernel = kernel_for_params(params)
                if kernel is None:
                    continue
                if all(isinstance(v, int) and v > 0
                       for v in params.values()) and \
                        not misaligned_params(kernel, params, dtype):
                    adopted[kernel] = params
    _SERVING_PARAMS.update(adopted)
    return adopted


def serving_param(kernel: str, name: str, fallback: int) -> int:
    """The adopted tuned value of ``kernel``'s ``name`` parameter, or
    ``fallback`` when no tuned DB has been adopted."""
    return int(_SERVING_PARAMS.get(kernel, {}).get(name, fallback))


def clear_tuned_params() -> None:
    """Drop adopted serving defaults (tests / model switches)."""
    _SERVING_PARAMS.clear()
