#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Drives the port's main paths.  The first two are Scission's loop
over a kernel-bearing graph, each with seeded random weights in bf16:

* prefill: flash attention -> dense -> SSD scan -> dense at zamba2-2.7b
  widths (one sequence of 4096 tokens, 32 heads of head_dim 80, SSM state
  64);
* decode: decode attention -> dense -> decode attention -> dense at
  granite-8b widths (16 sequences of one new token each, 32 query heads
  over 8 kv heads of head_dim 128, a full 4096-entry bf16 KV cache per
  attention layer).

Each path: build the hand-written CUDA kernels from
``src/repro_torch/kernels/csrc``; autotune the kernels' block sizes and
benchmark every block on two emulated resources into a ``BenchmarkDB``;
query the best partition (wired link, source ``edge1``); run it, and the
best two-stage partition, with ``PipelineExecutor``.

Each kernel's launch count is set to 0 right before its path runs and read
right after; it must be > 0.  Then the partitioned outputs are held against
a whole-graph run with the same kernels (exactly equal) and against the
whole graph with each kernel replaced by its plain PyTorch version with
TF32 off and bf16 activations between layers, as the graph has them; for
prefill the distance to the all-fp32 plain graph is printed.  Prefill is
held at the bf16 tolerance (3e-2 absolute plus 3e-2 relative); decode,
whose outputs are far smaller than that, at limits scaled to the output
(``check_decode``).  Each kernel is held against its plain version at its
path's shapes and timed with CUDA events, as device time (the host's
launch overhead excluded) and per call (included), beside its plain
version, its bound from the card's peak figures and, for attention,
``scaled_dot_product_attention`` as a yardstick, with its host work per
call.  Each row also gives the registers and spills of the bf16
tensor-core instances the path runs from the ``-Xptxas -v`` log and their
tensor-core instructions in the SASS (there must be some: HMMA for
``mma.sync``, HGMMA for the wide SSD's ``wgmma`` passes, which must also
load by TMA, UTMALDG); the flash and decode
rows their SASS opcode mix, the decode row ``nsplit`` and CTAs per SM, the
SSD row the bytes of its workspace and its device time with b and c in
buffers of their own (which must give the same output).

The third path, the zoo (``zoo_phase``), is the paper's six steps on its
18 CNNs at full size (batch 1, fp32 with TF32 off), through
``benchmarks/common_torch.py``'s five-tier testbed and calibration.  Each
net is built on the card, its blocks timed on every tier (fresh, no cache)
and the 4G partition queried; the chosen and the best staged partitions
must equal the whole graph bit for bit, and every block boundary must lie
within ``ZOO_TOL`` (relative norm) of the port's CPU run of the same
weights.  Each net's row gives its whole-graph time with CUDA events
(device time and per call), the kernels' busy time in one call from
``torch.profiler`` and the device's idle share, its fp32 roofline bound
from the eager operators' FLOPs and bytes (``CompiledCostProvider``: each
operator's inputs and outputs, unfused, each weight once), the sum of
its block times, the three slowest blocks, the query time and the peak
memory.  ResNet50 is then partitioned as a block DAG and run by
``DagPipelineExecutor`` under three assignments (the best, the best staged
one, and device and cloud in turn, so that branch and skip edges cross);
MobileNetV2 is timed into two fresh DBs; the first is written, queried under
3G and 4G (each best run stage by stage against the whole graph) and
without the cloud.  The run fails unless each tier's time agrees within
``ZOO_SPREAD`` between the two DBs, both answer device-native under 3G,
both find network scale factors at which the decision flips (device-native
under 3G, cloud-native under 4G) with upper edges within ``ZOO_SPREAD``,
and both give the same verdict under 4G at the calibration's scale, which
is printed with the flip's range.  The zoo path launches none of the
hand-written kernels, and the run fails if it does.

The fourth path, ``lm_phase``, runs the LM models and the serving engine
at full size with bf16 weights drawn on the card: granite-8b (36 layers,
d_model 4096, 32 query heads over 8 kv heads of head_dim 128) through
Scission's loop over ``lm_to_graph`` (one sequence of 2048 tokens; the
partitions equal the whole graph bit for bit; each group block replayed
from its CUDA graph equals an eager call) and through the bucketed engine
(width 8, 16 requests of 64-1024 tokens, 32 new each); zamba2-2.7b (54
Mamba-2 layers, a shared attention block of 32 heads of head_dim 80 every
6) through the exact engine (width 4, 8 requests of 128, 256 or 512
tokens, 16 new), whose decode step, captured as CUDA graphs, must hold
10 graphs and launch the SSD decode kernel 54 times in the capture;
zamba2-7b, the published Zamba2 (81 Mamba-2 layers, two
shared blocks applied before 13 of them, heads of 224, B and C in 2
groups), through the exact engine (width 4, 6 requests of 300, 1021, 2047
or 3468 tokens, none a multiple of its chunk, 16 new), whose run must
launch flash 13 times and ssd_scan 81 times an admission and
decode_attention 13 times a tick, and whose decode step, captured as CUDA
graphs, must hold 14 graphs around the 13 decode_attention cuts and launch
the SSD decode kernel 81 times in the capture, and whose graphed tick is
then timed at the chat cell's 34 slots with the kernel and with the plain
update and its copy in its place; and the reduced gemma2 of
``examples/partition_and_serve_torch.py``, whose local layers decode with
a window.  Each is driven with the launch counts set to 0 and must launch
every kernel it runs.  Each engine's requests are then held by a
teacher-forced check: prompt and generated tokens through ``forward`` with
the kernels and with their plain versions (the module attributes the
layers call, patched), logits within ``LM_TOL`` (relative norm;
zamba2-7b's deeper stack within ``ZAMBA2_7B_TOL``), and every
engine token equal to the plain argmax wherever the plain top-2 margin
exceeds ``LM_MARGIN`` times the largest logit difference.  Four more
decode_attention rows follow, under the sizes the paths adopted: one at
each engine's widths and the lengths of its heaviest decode step, the one
that read the most cache rows (granite-8b; zamba2's head_dim 80; the
example's head_dim 32 with its window of 16), and one at gemma2-9b's full
widths with its window of 4096, which no path runs and whose launches are
the example's, labelled so.  Three rows hold zamba2-7b's instances at the
chat cell's shapes against their plain versions: flash at head 224 over
its longest prompt (3468), decode at head 224 over its 34 slots of 4096,
and the SSD reading B and C of 2 groups of 56 heads over the longest
prompt (also bit for bit against its launch on the maps copied to each
head), each with the zamba2-7b path's launches; three rows hold the SSD
decode kernel (the one-token step, the state updated in place) against
its plain version, at zamba2-7b's heaviest tick (34 rows of 112 heads),
at zamba2-2.7b's decode (4 rows of 80 heads, one map of b and c, also
bit for bit against it as stride-0 views over the heads) and at
xlstm-125m's decode (4 rows of 4 heads of 384), timed beside the plain
version with the copy into the state it made.

The phase then runs the other model families at full size: qwen2-moe-a2.7b
(24 layers, 60 routed experts padded to 64, top-4, a shared expert; 29.7
GB of bf16 weights) through the DAG Scission loop over ``moe_to_graph`` of
its layer 0's MoE (2048 tokens) and the bucketed engine; xlstm-125m (12
layers alternating mLSTM and sLSTM) through the DAG loop over
``xlstm_to_graph`` (2048 tokens) and the exact engine, its mLSTMs reaching
``ssd_scan``'s wide route at 4 heads of 384; whisper-medium (24 + 24
layers) through a prefill over 8 sequences of 1500 synthetic frames and 32
greedy decode steps, launches counted by route (flash causal and
non-causal, decode over the self and the cross cache), then the DAG loop
over ``encdec_to_graph`` (448 tokens); and internvl2-76b's backbone at full
width, cut to ``INTERNVL_LAYERS`` of its 80 layers, over 256 synthetic
patch embeddings and 256 tokens a sequence.  A DAG loop fuses with
``fuse_block_dag``, times every block as CUDA-graph replays, queries
through the SP solver and runs the best, the best staged and an
interleaved partition with ``DagPipelineExecutor``, each equal to the
whole graph bit for bit.  whisper and internvl2 take the teacher-forced
check; the MoE and xLSTM engines, whose served computation differs from
``forward`` by the reference's semantics, are held against the same engine
under the plain versions fed the kernel run's tokens and routed as the
kernel run (``ENGINE_TOL``, ``ENGINE_MARGIN``); beside it, unchecked, a
plain run routed by its own router, the top-k routings that differ from
the kernel run's, and the MoE's error split by layer on its longest prompt
(``error_by_layer``, with two faults of the attention for scale).  The
xLSTM's wide SSD launches are required apart in its DAG loop and in its
engine.  Six rows follow: ``ssd_scan`` at the mLSTM's widths (its new
time beside the earlier kernel's, and where the time goes: each pass's
device time from a ``torch.profiler`` trace, their sum and a call's span),
``flash_attention`` without a mask at whisper's encoder (beside SDPA),
``decode_attention`` over whisper's cross cache and its self cache, and at
the qwen2-moe engine's and internvl2's widths (each beside masked SDPA),
at the lengths of the path's heaviest decode step.
The ``paper`` phase also runs ``bench_partitions_torch``'s DAG gate, whose
enc-dec LM must launch flash_attention (the zoo's benchmarks none).

The ``train`` phase follows ``lm_phase``: training at full size, through
``launch/steps.py``'s train step (the loss, its gradient, AdamW in place).
``flash_attention`` and ``ssd_scan`` run their kernels forward and, as
autograd Functions, the plain version's gradient backward.  xlstm-125m
trains with ``examples/train_small_lm_torch.py``'s settings for
``TRAIN_XLSTM`` steps at 8 × 512 tokens, checkpointed every 20 steps, and
must lower its loss and launch ``ssd_scan``'s wide route and its plain
backward; a fresh model then resumes from the step-20 checkpoint through
``TrainSupervisor`` for ``RESUME_STEPS`` steps, its state equal to the
saved one bit for bit and its losses within ``RESUME_TOL`` of the
uninterrupted run's.  Then four families as registered (remat, the loss
in chunks of 1024) at published widths (``train_family``): zamba2-2.7b
(``TRAIN_ZAMBA``: 2 × 2048 tokens), qwen2-moe-a2.7b cut to 4 of its 24
layers (``TRAIN_MOE``), whisper-medium whole (``TRAIN_WHISPER``: 4 × 448
tokens over 1500 frames) and internvl2-76b cut to 2 of its 80 layers
(``TRAIN_INTERNVL``: 256 patch embeddings and 1024 tokens).  Each takes
one loss and gradient with the kernels, with the plain versions in both
directions, with the kernels' gradients cut and with the plain versions
in fp32 (the MoE's last three routed as the kernel run; loss within
``LM_TOL``; the gradient tree within ``TRAIN_GRAD_TOL``, which the cut run
must exceed; each leaf only the kernels' gradients reach within
``TRAIN_LEAF_TOL``), then 3 steps that must launch its kernels and their
plain backward (flash counted by route: causal, the encoder's non-causal
self-attention, whisper's cross-attention), with finite losses and the
MoE's aux loss finite and above 0.  Each model's step time (forward and
loss, backward, AdamW; CUDA events), tokens/s, 6·N·tokens rate, peak
memory and launches by direction are printed beside the card's name and
power limit.  Last, at the path's shapes with launches counted from 0,
each kernel's forward is held against the plain version (``TOL``), each
Function's gradients against plain autograd's (``FN_GRAD_TOL``), and one
plain backward is timed (flash also at whisper's cross-attention, whose
row ``flash_attention_cross_whisper`` is added, and the row
``ssd_scan_mlstm_hd384_train`` times the wide SSD at the train path's
shape, 8 × 512, where its forwards run); the kernel rows carry the
phase's launches as ``launches_train``, flash's by family.

The ``mesh`` phase follows ``train``: the launch slice.  First the dry-run
on the card's host (``launch/dryrun.py``: ``meta`` DTensors over a fake
512-rank process group, no device touched) of zamba2-2.7b × train_4k on
the 16 x 16 mesh and granite-8b × decode_32k on 2 x 16 x 16 (``MESH_CELLS``),
each record printed with its roofline terms and the port's roofline table,
written to ``dryrun_torch.json`` under ``--out``; both must be OK, with
FLOPs, bytes, arguments and temporaries above 0 and the train cell's
collectives too.  Then, on a 1 x 1 ``DeviceMesh`` of the card over a
one-rank NCCL group, zamba2-2.7b trains ``MESH_ZAMBA`` steps at 2 × 2048
through the sharded train step (its parameters and moments DTensors
wrapping the tensors, no copy) after as many unsharded steps from the same
seed, and granite-8b prefills ``MESH_GRANITE``'s 8 × 1024 tokens and takes
16 greedy decode steps (under ``rules_for(decode_32k)``) sharded and
unsharded on the same weights.  Losses, parameters and logits must be equal
bit for bit and the tokens equal, and flash_attention, ssd_scan and
decode_attention must launch inside the mesh (counted from 0); each step's
time is printed beside the unsharded one's (DTensor's host cost).  The
kernel rows carry those launches as ``launches_mesh``.  Last, the split
decode that a mesh runs on a cache split on its sequence, on the one
card: granite-8b × decode_32k's rows of one rank (4 rows, 32,768-entry
caches cut into 16 slices of 2048) and gemma2-9b's local layer (window
4096, its lower edges inside slices), each slice through the kernel with
its lengths, ``starts`` and log-sum-exp, recombined by
``ref.combine_partials`` and held against the unsplit kernel and the plain
version (``check_decode``), the 16 slice calls timed beside one unsplit
call; the row ``decode_attention_lse_slice_granite`` times the kernel on
one slice with its log-sum-exp.

The ``analysis`` phase runs ``python -m repro_torch.analysis --strict`` over
every target with the card's shared-memory limit (the kernels' candidate
footprints and tile alignment at the paths' full-width shapes, the graph
checks, the FX dataflow lint of the zoo, the LMs' graphs and a kernel demo
graph whose kernel-bearing blocks are captured in CUDA graphs, the cost
checks), prints each footprint beside the limit, and runs
``bench_autotune_torch``'s sweep, its shared-memory and tiling pruning
gates and ``--verify-smem`` (every candidate the analysis admits at those
shapes launches, the smallest it prunes is refused with the same byte
count); every kernel must launch in it.

On the card every block time, and every autotuner trial, is the device
time of replays of the block captured in a CUDA graph (``TimingProvider``,
``KernelAutotuner``), as the reference times compiled programs; after each
loop every kernel-bearing block is captured and replayed once more and held
bit for bit against an eager call of it.

Usage: ``python3 chip_smoke.py [--out DIR]`` from the repo root; ``--out``
also writes the BenchmarkDBs and autotuner records there.  The last line of
standard output is ``{"ok": true, "device": {...}}``; any failure exits
non-zero without it.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0
B, S, H, HD, STATE = 1, 4096, 32, 80, 64     # zamba2-2.7b widths (prefill)
DB, DH, DHK, DHD, DS = 16, 32, 8, 128, 4096   # granite-8b widths (decode)
TOL = 3e-2                                   # bf16 (tests/test_kernels.py)
# decode: elementwise, DEC_ATOL x the output's RMS + DEC_RTOL x |value|; in
# all, ||got - want|| <= DEC_NORM x ||want||.  bf16 rounding alone is at
# most 2**-8 of each value.
DEC_ATOL, DEC_RTOL, DEC_NORM = 0.1, 1e-2, 1e-2
SLEEP_CYCLES = 2_000_000                     # ~1 ms at the H100's clocks
# zoo: the card's tensor at every block boundary against the port's CPU run
# of the same weights, fp32 with TF32 off: relative norm error.  Summation
# order and cuDNN's algorithms differ (~1e-6); a layout or padding fault
# gives errors of order 1.
ZOO_TOL = 1e-4
# zoo: the most that MobileNetV2's tier times, and the upper edges of its
# flip ranges, may differ between two fresh DBs of one run (relative to
# the smaller); decided before the first run with CUDA-graph timing
ZOO_SPREAD = 0.05

# dense peaks of the card (NVIDIA data sheets): bf16 tensor FLOP/s, bytes/s
PEAKS = {"H100 PCIe": (756e12, 2.0e12), "H100 NVL": (835e12, 3.9e12),
         "H100": (989e12, 3.35e12)}
# fp32 FLOP/s outside the tensor cores (the zoo's products, TF32 off)
FP32_PEAKS = {"H100 PCIe": 51e12, "H100 NVL": 60e12, "H100": 67e12}


def peaks(name: str) -> tuple[float, float]:
    for key, val in PEAKS.items():
        if key in name:
            return val
    raise RuntimeError(f"no peak figures for {name!r}")


def time_ms(fn, runs: int = 20, hold: bool = True) -> float:
    """Median of ``runs`` CUDA-event timings of ``fn()`` after a warm-up.

    With ``hold`` (device time), the device is held busy
    (``torch.cuda._sleep``) before each timing, so that the host enqueues
    the start event, the call and the end event before the start event
    fires: the events then time the device's work, not the host's launch
    overhead.  That the start event has not fired once the end event is
    enqueued is checked on every timing; where it has, the hold is doubled
    and the timing taken again.  Without ``hold`` (per call), each call
    starts on an idle device and the events see the host's launch overhead
    too."""
    import torch
    fn()
    torch.cuda.synchronize()
    cycles, times = SLEEP_CYCLES, []
    while len(times) < runs:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if hold:
            torch.cuda._sleep(cycles)
        start.record()
        fn()
        end.record()
        early = hold and start.query()
        end.synchronize()
        if not early:
            times.append(start.elapsed_time(end))
        elif cycles >= 64 * SLEEP_CYCLES:
            raise RuntimeError("time_ms: the host still enqueues the call "
                               f"after a hold of {cycles} cycles")
        else:
            cycles *= 2
    return statistics.median(times)


def host_ms(fn, calls: int = 50) -> float:
    """Host time per call of ``fn()`` (ms): the mean wall-clock of enqueuing
    ``calls`` calls while the device is held busy, so the host never waits
    for it; the wrapper's own work, the launch included."""
    import time
    import torch
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(64 * SLEEP_CYCLES)
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e3


def mma_build(what: str, ptxas: list, sass: list,
              opcode: str = "HMMA") -> dict:
    """Registers, spill stores and the fewest tensor-core instructions
    (``opcode``: HMMA for ``mma.sync``, HGMMA for ``wgmma``) of the bf16
    instances a path runs (their ``-Xptxas -v`` entries and SASS opcode
    counts); raises if an instance has none."""
    n = min(ops[opcode] for ops in sass)
    if not n:
        raise RuntimeError(f"{what}: a bf16 instance on the main path has no "
                           f"{opcode} instruction in its SASS")
    return {"registers": max(e["registers"] for e in ptxas),
            "spill_stores": max(e["spill_stores"] for e in ptxas),
            opcode.lower(): n}


def kernel_trace(fn, calls: int = 20) -> dict:
    """Per call of ``fn()``, from ``torch.profiler``'s device events of
    each of ``calls`` calls (one profiler session a call, ended by a
    synchronize, as ``device_busy_ms`` reads them): each kernel's median
    duration (ms, by name), their sum, and the span from the first
    kernel's start to the last one's end (below the sum where kernels
    overlap, above it by the gaps between them); calls whose session holds
    no device event are left out, and where none holds one the result is
    empty."""
    import re
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    by_name: dict[str, list] = {}
    spans, sums = [], []
    for _ in range(calls):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        call = [e for e in prof.events() if e.device_type == DeviceType.CUDA
                and not e.is_user_annotation]
        if not call:
            continue
        for e in call:
            m = re.search(r"(\w+)[<(]", e.name)
            by_name.setdefault(m.group(1) if m else e.name, []).append(
                e.time_range.elapsed_us() / 1e3)
        spans.append((max(e.time_range.end for e in call)
                      - min(e.time_range.start for e in call)) / 1e3)
        sums.append(sum(e.time_range.elapsed_us() for e in call) / 1e3)
    if not spans:
        return {}
    return {"kernel_ms": {k: statistics.median(v) for k, v in by_name.items()},
            "sum_ms": statistics.median(sums),
            "span_ms": statistics.median(spans), "calls": len(spans)}


def check_close(what: str, got, want, atol: float = TOL,
                rtol: float = TOL) -> float:
    """Max abs error of ``got`` against ``want``; raises unless they agree
    within ``atol`` absolute plus ``rtol`` relative."""
    import torch
    got, want = got.float(), want.float()
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol,
                               msg=lambda m: f"{what}: {m}")
    return (got - want).abs().max().item()


def check_decode(what: str, got, want, scale) -> tuple[float, float]:
    """(max abs error, relative norm error) of ``got`` against ``want``;
    raises unless every value lies within ``DEC_ATOL`` x the RMS of
    ``scale`` plus ``DEC_RTOL`` relative, and the error's norm within
    ``DEC_NORM`` of ``want``'s.  Decode outputs average thousands of
    cache rows, so they are far smaller than the bf16 tolerance."""
    import torch
    rms = scale.float().pow(2).mean().sqrt().item()
    err = check_close(what, got, want, atol=DEC_ATOL * rms, rtol=DEC_RTOL)
    rel = (torch.linalg.vector_norm(got.float() - want.float())
           / torch.linalg.vector_norm(want.float())).item()
    if not rel <= DEC_NORM:
        raise RuntimeError(f"{what}: relative norm error {rel:.4g} over "
                           f"{DEC_NORM}")
    return err, rel


def moved_bytes(*tensors) -> float:
    """Bytes a call must move when each input is read once and each output
    written once: tensors that share storage (``q = k = v``, or ``b = c``
    as views of ``x``) are counted once, at the widest of their spans."""
    spans: dict[int, int] = {}
    for t in tensors:
        key = t.untyped_storage().data_ptr()
        spans[key] = max(spans.get(key, 0), t.numel() * t.element_size())
    return float(sum(spans.values()))


def scission_loop(label, graph, x, resources, net, dev, out_dir):
    """Autotune -> BenchmarkDB -> query -> partitioned runs of ``graph`` on
    input ``x``; prints what each step chose and returns the partitioned
    outputs as {label: (config, y, timings)} and the DB."""
    from repro_torch.core import (Query, QueryEngine, TimingProvider,
                                  benchmark_model)
    from repro_torch.kernels import KernelAutotuner
    from repro_torch.runtime import PipelineExecutor

    tuner = KernelAutotuner(runs=2, device=dev)
    db = benchmark_model(graph, resources, TimingProvider(tuner=tuner,
                                                          device=dev), runs=5)
    result = QueryEngine(db, resources, net, source="edge1",
                         input_bytes=float(x.numel() * x.element_size())
                         ).run(Query(top_n=20))
    best = result.best
    staged = next((c for c in result.configs if len(c.segments) > 1), None)
    runs = {"best": best} if staged is None else {"best": best,
                                                  "two-stage": staged}
    outputs = {}
    for name, cfg in runs.items():
        pipe = PipelineExecutor(graph, cfg, net, source="edge1", device=dev)
        pipe.run(x)                     # warm-up: the timed run is the second
        y, timings = pipe.run(x, collect_timing=True)
        outputs[name] = (cfg, y, timings)

    for rec in tuner.records.values():
        trials = {k: round(v * 1e3, 3) for k, v in rec.trials.items()}
        pruned = {k: int(v) for k, v in rec.pruned.items()}
        print(f"{label} tune {rec.kernel} @{rec.resource} {rec.shape_key}: "
              f"winner {rec.params} ({rec.time_s * 1e3:.3f} ms, default "
              f"{rec.default_params} {rec.default_time_s * 1e3:.3f} ms); "
              f"trials ms {trials}; pruned over {int(rec.vmem_limit)} B "
              f"{pruned}")
    for res in resources:
        print(f"{label} db {res.name}: " + ", ".join(
            f"block {r.block} {r.mean_time_s * 1e3:.3f} ms"
            for r in db.records[res.name]))
    print(f"{label} query ({result.strategy}, "
          f"{result.query_time_s * 1e3:.1f} ms): best {best.describe()}")
    for name, (cfg, y, timings) in outputs.items():
        print(f"{label} pipeline {name} {cfg.describe()}: " + "; ".join(
            f"{t.resource} compute {t.compute_s * 1e3:.3f} ms, link "
            f"{t.comm_in_s * 1e3:.3f} ms, {t.bytes_in} B in"
            for t in timings))
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        Path(out_dir, f"chip_smoke_{label}_db.json").write_text(db.to_json())
        Path(out_dir, f"chip_smoke_{label}_tuner.json").write_text(
            tuner.to_json())
    return outputs, db


def check_partitions(label, graph, x, outputs):
    """The whole-graph run, which every partitioned output must equal."""
    import torch
    from repro_torch.core import fuse_blocks
    whole = x
    for blk in fuse_blocks(graph):
        whole = blk.make_callable()(whole)
    for name, (_, y, _) in outputs.items():
        if y.shape != whole.shape or not torch.equal(y, whole):
            raise RuntimeError(f"{label}: {name} partitioned output differs "
                               "from the whole-graph run")
    return whole


def require_launches(launches: dict) -> None:
    """Each kernel launched on the main path: its wrapper counts a launch
    when it runs, so the warm-up calls and the CUDA-graph captures of the
    autotuner and the TimingProvider count, and the timed replays do
    not."""
    print(f"main-path launches {launches}")
    for k, n in launches.items():
        if n <= 0:
            raise RuntimeError(f"{k} was never launched on the main path")


def check_replay(label, graph, x, dev, kernel_of=None) -> None:
    """Each kernel-bearing block of ``graph``, captured in a CUDA graph as
    the TimingProvider captures it, then replayed: its output must equal an
    eager call of the block on the same input bit for bit, which shows the
    kernel runs inside the graph the timings replay.  ``kernel_of(node)``
    names the kernel a node launches (default: its tunable ``kernel``)."""
    import torch
    from repro_torch._device import capture
    from repro_torch.core import fuse_blocks
    h, checked = x, []
    for blk in fuse_blocks(graph):
        fn = blk.make_callable()
        want = fn(h)
        kernels = [k for i in blk.node_ids
                   if (k := (kernel_of or (lambda n: n.kernel))(
                       graph.nodes[i]))]
        if kernels:
            cuda_graph, got = capture(fn, (h,), dev)
            cuda_graph.replay()
            torch.cuda.synchronize()
            if got.shape != want.shape or not torch.equal(got, want):
                raise RuntimeError(f"{label}: block {blk.index} "
                                   f"({blk.name}) replayed from its CUDA "
                                   "graph differs from an eager call")
            checked.append(f"block {blk.index} ({'+'.join(kernels)})")
            del got
            cuda_graph.reset()
        h = want
    if not checked:
        raise RuntimeError(f"{label}: no kernel-bearing block to replay")
    print(f"{label} replay: {', '.join(checked)} replayed from a CUDA graph "
          "equal an eager call bit for bit")


def prefill_phase(dev, resources, net, out_dir, launches):
    """The prefill path at zamba2-2.7b widths; returns its kernel rows and
    its BenchmarkDB."""
    import torch
    import torch.nn.functional as F

    from repro_torch.core import TensorSpec
    from repro_torch.kernel_graph import kernel_graph
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa_mod
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_scan as ssd_mod

    gen = torch.Generator().manual_seed(SEED)
    weights = {n: (torch.randn(HD, HD, generator=gen) * 0.05)
               .to(dev, torch.bfloat16) for n in ("mlp0", "mlp1")}
    x = torch.randn(B, S, H, HD, generator=gen).to(dev, torch.bfloat16)
    spec = TensorSpec((B, S, H, HD), torch.bfloat16)
    graph = kernel_graph(spec, weights, state_dim=STATE, device=dev)

    start = kernel_launches()
    outputs, db = scission_loop("prefill", graph, x, resources, net, dev,
                                out_dir)
    launches.update(kernel_launches(start, ("flash_attention", "ssd_scan")))
    require_launches(launches)
    check_replay("prefill", graph, x, dev)

    # -- whole-graph checks ----------------------------------------------
    whole = check_partitions("prefill", graph, x, outputs)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ssd_node = next(n for n in graph.nodes if n.kernel == "ssd_scan")
    chunk = ssd_node.kernel_params["chunk"]

    def plain_graph(h):
        """The graph with each kernel replaced by its plain version (fp32
        arithmetic inside, activations handed on in the input's dtype)."""
        h = ref.flash_attention_ref(h, h, h, causal=True)
        h = torch.tanh(h @ weights["mlp0"].to(h.dtype))
        bc = h[..., :STATE]
        h, _ = ref.ssd_ref(h, -F.softplus(h.mean(dim=-1)), bc, bc,
                           chunk=chunk)
        return torch.tanh(h @ weights["mlp1"].to(h.dtype))

    with torch.no_grad():
        plain = plain_graph(x)
        plain_f32 = plain_graph(x.float())
    graph_err = check_close("prefill graph output vs plain", whole, plain)
    # reported, not checked: the graph rounds its activations to bf16
    # between layers, which the all-fp32 plain graph does not
    f32_diff = (whole.float() - plain_f32).abs()
    f32_out = int((f32_diff > TOL + TOL * plain_f32.abs()).sum())
    print(f"prefill graph output {tuple(whole.shape)} {whole.dtype}: equal "
          f"across {list(outputs)} partitions and the whole-graph run; max "
          f"abs err vs the plain versions {graph_err:.4g} (tol {TOL} abs + "
          f"{TOL} rel); vs the plain versions with fp32 activations "
          f"{f32_diff.max().item():.4g}, {f32_out} of {f32_diff.numel()} "
          f"values outside the tolerance (not checked)")
    del plain, plain_f32, f32_diff

    # -- per kernel at the main path's shapes -----------------------------
    attn_node = next(n for n in graph.nodes if n.kernel == "flash_attention")
    bq = attn_node.kernel_params["block_q"]
    bk = attn_node.kernel_params["block_k"]
    kernels = []

    q = x
    got = fa_mod.flash_attention(q, q, q, causal=True, block_q=bq, block_k=bk)
    qf = q.float()
    err = check_close("flash_attention vs plain", got,
                      ref.flash_attention_ref(qf, qf, qf, causal=True))
    def call():
        return fa_mod.flash_attention(q, q, q, causal=True, block_q=bq,
                                      block_k=bk)
    ms, call_ms = time_ms(call), time_ms(call, hold=False)
    host = host_ms(call)
    plain_ms = time_ms(lambda: ref.flash_attention_ref(qf, qf, qf,
                                                       causal=True), runs=10)
    qt = q.transpose(1, 2).contiguous()
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qt, qt, qt, is_causal=True))
    pairs = S * (S + 1) // 2                 # unmasked (q, k) pairs, causal
    flops = 4.0 * B * H * HD * pairs
    nbytes = moved_bytes(q, q, q, got)            # q = k = v read; o written
    # the bf16 instances at this head_dim (the launch ran one of them):
    # their ptxas report and their tensor-core instructions in the SASS
    ptxas = fa_mod.mma_instances(_build.ptxas_report("flash_attention"))
    sass = fa_mod.mma_instances(_build.sass_opcodes("flash_attention"))
    hmma = min(ops["HMMA"] for ops in sass[HD])
    if not hmma:
        raise RuntimeError(f"flash_attention: a bf16 instance at head_dim "
                           f"{HD} has no HMMA instruction in its SASS")
    mix = sum(sass[HD], Counter())
    print(f"flash_attention bf16 instances at head_dim {HD}: "
          f"{len(sass[HD])}; SASS {sum(mix.values())} instructions, "
          + ", ".join(f"{op} {n}" for op, n in mix.most_common(16)))
    kernels.append(dict(
        name="flash_attention", tpu="flash_attention.py:122",
        design="mma.sync bf16",
        build=dict(registers=max(e["registers"] for e in ptxas[HD]),
                   spill_stores=max(e["spill_stores"] for e in ptxas[HD]),
                   hmma=hmma,
                   spilling_head_dims=sorted(
                       hd for hd, es in ptxas.items()
                       if any(e["spill_stores"] for e in es))),
        shapes=f"q=k=v {tuple(q.shape)} bf16 causal, block_q={bq} "
               f"block_k={bk}", err=err, tol=f"tol {TOL} abs + {TOL} rel",
        ms=ms, call_ms=call_ms, host_ms=host, plain_ms=plain_ms,
        flops=flops, nbytes=nbytes, lib_ms=lib_ms))

    gen = torch.Generator().manual_seed(SEED + 1)
    xs = torch.tanh(torch.randn(B, S, H, HD, generator=gen)).to(
        dev, torch.bfloat16)
    la = -F.softplus(xs.mean(dim=-1))
    bc = xs[..., :STATE]
    y, fin = ssd_mod.ssd_scan(xs, la, bc, bc, chunk=chunk)
    y_ref, fin_ref = ref.ssd_ref(xs.float(), la.float(), bc.float(),
                                 bc.float(), chunk=chunk)
    err = check_close("ssd_scan y vs plain", y, y_ref)
    fin_err = check_close("ssd_scan final state vs plain", fin, fin_ref)
    def call():
        return ssd_mod.ssd_scan(xs, la, bc, bc, chunk=chunk)
    ms, call_ms = time_ms(call), time_ms(call, hold=False)
    host = host_ms(call)
    split = kernel_trace(call).get("kernel_ms", {})
    # the general route, which copies b and c into shared memory rows of
    # their own: b and c as the same views of two other copies of x, so
    # the launch cannot read them from x's rows
    b2, c2 = (xs.clone()[..., :STATE] for _ in range(2))
    if not all(torch.equal(u, w) for u, w in zip(
            ssd_mod.ssd_scan(xs, la, b2, c2, chunk=chunk), (y, fin))):
        raise RuntimeError("ssd_scan: b and c in buffers of their own give "
                           "another result than the node's views of x")
    separate_ms = time_ms(lambda: ssd_mod.ssd_scan(xs, la, b2, c2,
                                                   chunk=chunk))
    del b2, c2
    xsf, laf, bcf = xs.float(), la.float(), bc.float()
    plain_ms = time_ms(lambda: ref.ssd_ref(xsf, laf, bcf, bcf, chunk=chunk),
                       runs=10)
    L, nc = min(chunk, S), -(-S // min(chunk, S))
    tri = L * (L + 1) // 2                   # causal (i, j) pairs per chunk
    flops = 2.0 * B * H * nc * (tri * STATE + tri * HD + 2 * L * STATE * HD)
    nbytes = moved_bytes(xs, la, bc, bc, y, fin)
    # the fp32 chunk states and decays the three passes hand on: traffic
    # beyond the bound's inputs and outputs
    ws_bytes = ssd_mod.workspace_bytes({"chunk": chunk}, (xs.shape, bc.shape),
                                       xs.dtype)
    # the instances this launch runs: P = HD, log_a in bf16
    passes = {name: ssd_mod.mma_passes(report("ssd_scan"), HD, la.dtype)
              for name, report in (("ptxas", _build.ptxas_report),
                                   ("sass", _build.sass_opcodes))}
    build = mma_build("ssd_scan", sum(passes["ptxas"].values(), []),
                      sum(passes["sass"].values(), []))
    print("ssd_scan device time per pass (torch.profiler): " + (", ".join(
        f"{k} {v:.4f} ms" for k, v in split.items()) or "not measured"))
    print("ssd_scan bf16 passes: " + "; ".join(
        f"{name}: registers {max(e['registers'] for e in es)}, spill stores "
        f"{max(e['spill_stores'] for e in es)}, HMMA "
        f"{min(o['HMMA'] for o in passes['sass'][name])}"
        for name, es in sorted(passes["ptxas"].items())))
    kernels.append(dict(
        name="ssd_scan", tpu="ssd_scan.py:93",
        design="mma.sync bf16, chunk-parallel 3-pass",
        build=dict(**build, workspace_bytes=ws_bytes,
                   separate_ms=separate_ms),
        shapes=f"x {tuple(xs.shape)} bf16, b=c {tuple(bc.shape)}, "
               f"chunk={chunk}; final-state max abs err {fin_err:.4g}; "
               f"workspace {ws_bytes} B; b and c in buffers of their own: "
               f"the same output, {separate_ms:.4f} ms of device time",
        err=err, tol=f"tol {TOL} abs + {TOL} rel", ms=ms, call_ms=call_ms,
        host_ms=host, plain_ms=plain_ms, flops=flops, nbytes=nbytes,
        lib_ms=None))
    return kernels, db


def decode_phase(dev, resources, net, out_dir, launches):
    """The decode path at granite-8b widths; returns its kernel row."""
    import torch
    import torch.nn.functional as F

    from repro_torch.core import TensorSpec
    from repro_torch.kernel_graph import decode_graph
    from repro_torch.kernels import _build
    from repro_torch.kernels import decode_attention as da_mod
    from repro_torch.kernels import ref

    # A full-cache attention output averages about DS / e rows of unit v
    # (its logits are N(0, 1)), an RMS of sqrt(e / DS).  The dense weights
    # are scaled so that tanh's input, and so the second attention layer's
    # query, is of order 1: its softmax is far from uniform.
    w_scale = math.sqrt(DS / (math.e * DHD))
    gen = torch.Generator().manual_seed(SEED + 2)
    weights = {n: (torch.randn(DHD, DHD, generator=gen) * w_scale)
               .to(dev, torch.bfloat16) for n in ("mlp0", "mlp1")}
    q = torch.randn(DB, DH, DHD, generator=gen).to(dev, torch.bfloat16)
    dgen = torch.Generator(device=dev).manual_seed(SEED + 3)
    cshape = (DB, DS, DHK, DHD)
    caches = {n: tuple(torch.randn(cshape, generator=dgen, device=dev,
                                   dtype=torch.bfloat16) for _ in range(2))
              for n in ("attn0", "attn1")}
    graph = decode_graph(TensorSpec(q.shape, torch.bfloat16), weights,
                         cache_len=DS, kv_heads=DHK, head_dim=DHD,
                         caches=caches, device=dev)

    start = kernel_launches()
    outputs, _ = scission_loop("decode", graph, q, resources, net, dev,
                               out_dir)
    got = kernel_launches(start, ("decode_attention",))
    launches.update(got)
    require_launches(got)
    check_replay("decode", graph, q, dev)

    # -- whole-graph checks ----------------------------------------------
    whole = check_partitions("decode", graph, q, outputs)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    full = torch.full((DB,), DS, dtype=torch.int32, device=dev)

    def plain_graph(h):
        """The graph with each kernel replaced by its plain version (fp32
        arithmetic inside, bf16 activations between layers), and the RMS
        of each attention layer's query."""
        q_rms = []
        for i in (0, 1):
            q_rms.append(h.float().pow(2).mean().sqrt().item())
            k, v = caches[f"attn{i}"]
            h = ref.decode_attention_ref(h, k, v, full)
            h = torch.tanh(h @ weights[f"mlp{i}"].to(h.dtype))
        return h, q_rms

    with torch.no_grad():
        plain, q_rms = plain_graph(q)
    graph_err, graph_rel = check_decode("decode graph output vs plain", whole,
                                        plain, plain)
    print(f"decode graph output {tuple(whole.shape)} {whole.dtype}: equal "
          f"across {list(outputs)} partitions and the whole-graph run; vs "
          f"the plain versions max abs err {graph_err:.4g}, relative norm "
          f"err {graph_rel:.4g} (tol {DEC_ATOL} x RMS abs + {DEC_RTOL} rel, "
          f"norm {DEC_NORM}); output RMS "
          f"{plain.float().pow(2).mean().sqrt().item():.4g}, attention "
          f"queries' RMS " + ", ".join(f"{r:.4g}" for r in q_rms))

    # -- the kernel at the main path's shapes -----------------------------
    node = next(n for n in graph.nodes if n.kernel == "decode_attention")
    bk = node.kernel_params["block_k"]
    k, v = caches["attn0"]
    qf, kf, vf = q.float(), k.float(), v.float()
    got = da_mod.decode_attention(q, k, v, full, block_k=bk)
    want = ref.decode_attention_ref(qf, kf, vf, full)
    err, rel = check_decode("decode_attention vs plain, full cache", got,
                            want, want)
    # lengths 0, 1, full and ragged, at the full cache's limits; the timed
    # call is the main path's, every row full
    lgen = torch.Generator().manual_seed(SEED + 4)
    mixed = torch.cat([torch.tensor([0, 1, DS]),
                       torch.randint(2, DS, (DB - 3,), generator=lgen)]
                      ).to(dev, torch.int32)
    mixed_err, mixed_rel = check_decode(
        "decode_attention vs plain, lengths 0, 1, full and ragged",
        da_mod.decode_attention(q, k, v, mixed, block_k=bk),
        ref.decode_attention_ref(qf, kf, vf, mixed), want)

    def call():
        return da_mod.decode_attention(q, k, v, full, block_k=bk)
    ms, call_ms = time_ms(call), time_ms(call, hold=False)
    host = host_ms(call)
    split = kernel_trace(call).get("kernel_ms", {})
    plan = da_mod.split_plan(q, k, bk)
    plain_ms = time_ms(lambda: ref.decode_attention_ref(qf, kf, vf, full),
                       runs=10)
    del kf, vf
    lib_ms, lib_note = None, ""
    sdpa_doc = F.scaled_dot_product_attention.__doc__ or ""
    if "enable_gqa" in sdpa_doc:
        qv = q.view(DB, DH, 1, DHD)
        kt, vt = (t.transpose(1, 2).contiguous() for t in (k, v))
        check_decode("scaled_dot_product_attention vs plain",
                     F.scaled_dot_product_attention(qv, kt, vt,
                                                    enable_gqa=True)
                     .view(q.shape), want, want)
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
            qv, kt, vt, enable_gqa=True))
        del kt, vt
    else:
        lib_note = (f"; library n/a: torch {torch.__version__}'s "
                    "scaled_dot_product_attention has no enable_gqa")
    rows = int(full.sum())                   # cache rows the call reads
    flops = 4.0 * DH * DHD * rows
    nbytes = moved_bytes(q, got, full) + 2.0 * rows * DHK * DHD * \
        k.element_size()
    ptxas = da_mod.mma_instances(_build.ptxas_report("decode_attention"))
    sass = da_mod.mma_instances(_build.sass_opcodes("decode_attention"))
    build = mma_build("decode_attention", [ptxas[DHD]], [sass[DHD]])
    mix = sass[DHD]
    print(f"decode_attention bf16 instance at head_dim {DHD}: SASS "
          f"{sum(mix.values())} instructions, "
          + ", ".join(f"{op} {n}" for op, n in mix.most_common(12)))
    print("decode_attention device time per kernel (torch.profiler): " + (
        ", ".join(f"{k} {v:.4f} ms" for k, v in split.items())
        or "not measured"))
    return [dict(
        name="decode_attention", tpu="decode_attention.py:100",
        design="mma.sync bf16, split-KV, one wave",
        build=dict(**build, nsplit=plan["nsplit"],
                   ctas_per_sm=plan["ctas_per_sm"],
                   smem_bytes=plan["smem_bytes"]),
        shapes=f"q {tuple(q.shape)} bf16, k, v {cshape} bf16, lengths all "
               f"{DS}, block_k={bk}; output RMS "
               f"{want.pow(2).mean().sqrt().item():.4g}, relative norm err "
               f"{rel:.4g}; lengths 0, 1, {DS} and ragged: max abs err "
               f"{mixed_err:.4g}, relative norm err {mixed_rel:.4g}"
               f"{lib_note}",
        err=max(err, mixed_err),
        tol=f"tol {DEC_ATOL} x RMS abs + {DEC_RTOL} rel, norm {DEC_NORM}",
        ms=ms, call_ms=call_ms, host_ms=host, plain_ms=plain_ms,
        flops=flops, nbytes=nbytes, lib_ms=lib_ms)]


# -- the LM models and the serving engine -----------------------------------
# granite-8b: lm_to_graph's Scission loop at one sequence of LM_GRAPH_SEQ
# tokens, then the engine (bucketed admission) over LM_REQUESTS seeded
# requests; zamba2-2.7b: the engine (exact admission) alone.
LM_GRAPH_SEQ = 2048
GRANITE_ENGINE = dict(width=8, max_len=2048, requests=16, prompt=(64, 1024),
                      new=32)
ZAMBA_ENGINE = dict(width=4, max_len=1024, requests=8,
                    prompts=(128, 256, 512), new=16)
# zamba2-7b (the published Zamba2): the exact engine over ragged prompts of
# the chat cell's range, none a multiple of its chunk of 256; its kernel
# rows at the chat cell's shapes: flash and the grouped SSD at its longest
# prompt, decode over its 34 slots of 4096 at lengths drawn from its range
ZAMBA2_7B_ENGINE = dict(width=4, max_len=4096, requests=6,
                        prompts=(300, 1021, 2047, 3468), new=16)
ZAMBA2_7B_ROWS = dict(prompt=3468, width=34, max_len=4096, lengths=(300, 3988))
# replays of the graphed zamba2-7b tick a timing takes (~35-50 ms each)
TICK_RUNS = 10
# teacher-forced check, decided before the first run on the card: the
# kernels' logits against the plain versions' by relative norm error
# (tests/test_kernels.py:18-19), and each engine token equal to the plain
# argmax wherever the plain top-2 margin exceeds LM_MARGIN x the request's
# largest logit difference between the two runs
LM_TOL = 3e-2
LM_MARGIN = 2.0
# zamba2-7b's teacher-forced bound: its 81 Mamba-2 layers and 13 shared
# applications carry bf16 roundings further than the other stacks, so the
# sound kernels read 0.049-0.062 against the plain versions (six requests,
# an H100), past LM_TOL; set near the geometric middle between that and the
# subtler of two planted faults of the new instances: the last 32 of 224
# query dimensions dropped in flash reads 0.171-0.384, the groups of B and
# C swapped in the SSD 1.120-1.185
ZAMBA2_7B_TOL = 0.1


class StepClock:
    """The device time of each call of a wrapped step: CUDA events around
    the call, so the time between them includes any gap in which the
    device waited for the host's launches."""

    def __init__(self):
        self.events = []

    def wrap(self, fn):
        import torch

        def timed(*args):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args)
            end.record()
            self.events.append((start, end))
            return out
        return timed

    def ms(self) -> list[float]:
        import torch
        torch.cuda.synchronize()
        return [s.elapsed_time(e) for s, e in self.events]


def plain_ssd_decode(state, x, la, b, c, *, out=None):
    """The SSD decode's plain version (``kernels/ref.py``) under the
    wrapper's signature: the new state copied into ``out`` when given, as
    the decode step before the kernel copied it into the cache."""
    from repro_torch.kernels import ref
    y, st = ref.ssd_decode_ref(state, x, la, b, c)
    return y, (st if out is None else out.copy_(st))


def _plain_kernels():
    """The model's kernel entry points replaced by their plain versions
    (``kernels/ref.py``), as a context manager: the module attributes the
    layers call are patched, and restored on exit."""
    import contextlib

    from repro_torch.kernels import ref
    from repro_torch.models import encdec
    from repro_torch.models import layers as L
    from repro_torch.models import ssm, xlstm

    @contextlib.contextmanager
    def patched():
        saved = (L.flash_attention, L.decode_attention, ssm.ssd_scan,
                 encdec.flash_attention, encdec.decode_attention,
                 ssm.ssd_decode, xlstm.ssd_decode)
        L.flash_attention = encdec.flash_attention = lambda q, k, v, *, \
            causal=True, window=None, softcap=None, block_q=None, \
            block_k=None: ref.flash_attention_ref(
                q, k, v, causal=causal, window=window, softcap=softcap)

        def plain_decode(q, k, v, lengths, *, softcap=None, window=None,
                         block_k=None, out=None):
            o = ref.decode_attention_ref(q, k, v, lengths, softcap=softcap,
                                         window=window)
            # the graphed decode step hands its eager call a buffer
            return o if out is None else out.copy_(o)

        L.decode_attention = encdec.decode_attention = plain_decode
        ssm.ssd_scan = lambda x, la, b, c, *, chunk: ref.ssd_ref(
            x, la, b, c, chunk=chunk)
        ssm.ssd_decode = xlstm.ssd_decode = plain_ssd_decode
        try:
            yield
        finally:
            (L.flash_attention, L.decode_attention, ssm.ssd_scan,
             encdec.flash_attention, encdec.decode_attention,
             ssm.ssd_decode, xlstm.ssd_decode) = saved

    return patched()


def _hold(label, rid, got, want, toks, tol, margin, gen=slice(None)):
    """One request's logits against the plain run's: raises unless their
    relative norm error is within ``tol`` and each of ``toks`` (the tokens
    served at positions ``gen``) equals the plain argmax wherever the plain
    top-2 margin exceeds ``margin`` x the largest logit difference there;
    returns (relative error, largest difference, held, positions, agree)."""
    import numpy as np
    import torch

    rel = (torch.linalg.vector_norm(got - want)
           / torch.linalg.vector_norm(want)).item()
    if not rel <= tol:
        raise RuntimeError(f"{label} request {rid}: logits' relative norm "
                           f"error {rel:.4g} over {tol}")
    got, want = got[gen], want[gen]
    diff = (got - want).abs().max().item()
    top2 = want.topk(2, dim=-1).values
    gap = (top2[:, 0] - top2[:, 1]).cpu().numpy()
    plain_tok = want.argmax(dim=-1).cpu().numpy()
    toks = np.asarray(toks)
    hold = gap > margin * diff
    bad = hold & (toks != plain_tok)
    if bad.any():
        raise RuntimeError(
            f"{label} request {rid}: served tokens differ from the plain "
            f"argmax at held positions {np.nonzero(bad)[0]} (margins "
            f"{gap[bad]}, largest logit difference {diff})")
    return rel, diff, int(hold.sum()), len(hold), int((toks == plain_tok)
                                                      .sum())


def _holds(label, what, holds, tol, margin, note="") -> dict:
    """``_hold``'s results over a path's requests, printed as one line;
    raises if no position was held."""
    rel, diff, held, positions, agree = (
        max(h[0] for h in holds), max(h[1] for h in holds),
        *(sum(h[i] for h in holds) for i in (2, 3, 4)))
    if held == 0:
        raise RuntimeError(f"{label}: the {what} check held no position")
    print(f"{label} {what}: {len(holds)} requests, logits' relative norm "
          f"error up to {rel:.4g} (bound {tol}), largest logit difference "
          f"{diff:.4g}; tokens held at {held} of {positions} generated "
          f"positions (plain top-2 margin > {margin} x the difference), all "
          f"equal; served tokens equal the plain argmax at {agree} of "
          f"{positions} (not checked){note}")
    return dict(held=held, positions=positions, rel=rel, diff=diff,
                agree=agree)


def teacher_forced(label, model, params, done, pad_to: int = 1,
                   inputs=None, prefix: int = 0, tol: float = LM_TOL) -> dict:
    """Each finished request's prompt and generated tokens (the last one
    dropped) through ``forward`` twice, with the kernels and with their
    plain versions; ``pad_to`` pads the sequence with zeros to a multiple
    (Mamba-2's chunk), which causal layers never show the real positions.
    ``inputs(r)`` gives a request's other ``forward`` arguments (frames,
    patch embeddings), and ``prefix`` the positions they put before the
    tokens.  Raises unless the logits agree within ``tol`` (relative
    norm, every position; ``LM_TOL`` unless given) and the engine's tokens
    equal the plain argmax at every held position (``_hold``,
    ``LM_MARGIN``); returns the counts and worst errors."""
    import numpy as np
    import torch
    from repro_torch.models import layers as L

    def logits(toks, kw):
        with torch.no_grad():
            hidden, _ = model.forward(params, toks, **kw)
            return L.unembed(params["embed"], hidden[:, prefix:],
                             softcap=model.cfg.final_softcap)[0]

    holds = []
    for r in sorted(done, key=lambda r: r.rid):
        seq = np.concatenate([r.prompt, r.tokens[:-1]]).astype(np.int32)
        n = len(seq)
        padded = np.zeros(-(-n // pad_to) * pad_to, np.int32)
        padded[:n] = seq
        toks = torch.as_tensor(padded, device=model.device)[None]
        kw = inputs(r) if inputs else {}
        got = logits(toks, kw)[:n]
        with _plain_kernels():
            want = logits(toks, kw)[:n]
        holds.append(_hold(label, r.rid, got, want, r.tokens, tol,
                           LM_MARGIN, gen=slice(len(r.prompt) - 1, n)))
    return _holds(label, "teacher-forced", holds, tol, LM_MARGIN)


def decode_lengths():
    """A context manager that records, for each decode step any
    ``ServingEngine`` takes inside it, the ``lengths`` ``decode_attention``
    is given: each slot's cache length plus one (1 for a free slot), read
    from the host's pool before the step; it yields the list of steps."""
    import contextlib

    from repro_torch.serving import engine as engine_mod

    @contextlib.contextmanager
    def recording():
        steps = []
        real = engine_mod.ServingEngine._decode_step

        def step(self, finished):
            steps.append([int(n) + 1 for n in self.pool.lengths])
            return real(self, finished)
        engine_mod.ServingEngine._decode_step = step
        try:
            yield steps
        finally:
            engine_mod.ServingEngine._decode_step = real

    return recording()


# each count of kernel_launches, by the tracing counter that holds it
LAUNCH_COUNTERS = {
    "flash_attention": "flash_attention_launches",
    "decode_attention": "decode_attention_launches",
    "ssd_scan": "ssd_scan_launches",
    "ssd_scan wide route": "ssd_scan_wide_launches",
    "ssd_decode": "ssd_decode_launches",
    "flash_attention backward (plain)": "flash_attention_backward_launches",
    "ssd_scan backward (plain)": "ssd_scan_backward_launches"}
KERNELS = ("flash_attention", "ssd_scan", "decode_attention")


def kernel_launches(since: dict | None = None,
                    keys=tuple(LAUNCH_COUNTERS)) -> dict:
    """The counts of ``keys`` (``tracing``'s counters): the kernels'
    launches, the SSD's wide route's apart, and the plain versions'
    recomputations the autograd Function's backward runs (training);
    since the process began, or since ``since``, an earlier reading."""
    from repro_torch import tracing
    counts, since = tracing.counters(), since or {}
    return {k: counts[LAUNCH_COUNTERS[k]] - since.get(k, 0) for k in keys}


def heaviest(steps: list) -> list[int]:
    """The decode step that read the most cache rows (the largest sum of
    lengths; the first of equals)."""
    return max(steps, key=sum)


def serve(label, model, params, requests, width, max_len) -> dict:
    """``requests`` through a ``ServingEngine``: warm-up, then one timed
    ``run``.  Prints and returns requests, tokens, wall time, tok/s, TTFT
    p50/p99, the median prefill and decode step (``StepClock``), the peak
    memory of the run and the lengths of its heaviest decode step."""
    import time

    import numpy as np
    import torch
    from repro_torch.serving import ServingEngine

    eng = ServingEngine(model, params, width=width, max_len=max_len)
    for r in requests:
        eng.submit(r)
    eng.warmup()
    prefill, decode = StepClock(), StepClock()
    eng._prefill = prefill.wrap(eng._prefill)
    eng._decode = decode.wrap(eng._decode)
    torch.cuda.reset_peak_memory_stats()
    start = time.perf_counter()
    for r in requests:           # each request's clock starts with the run
        r.submitted_at = start
    before = kernel_launches()
    with decode_lengths() as steps:
        done = eng.run()
    torch.cuda.synchronize()
    in_run = kernel_launches(before)
    stats = eng.stats
    ttft = [r.ttft_s * 1e3 for r in done]
    out = dict(requests=stats.requests, tokens=stats.tokens,
               wall_s=stats.wall_s, tok_s=stats.tokens_per_s,
               ttft_p50_ms=float(np.percentile(ttft, 50)),
               ttft_p99_ms=float(np.percentile(ttft, 99)),
               prefill_ms=statistics.median(prefill.ms()),
               prefills=len(prefill.events),
               decode_ms=statistics.median(decode.ms()),
               decode_steps=len(decode.events),
               peak_gb=torch.cuda.max_memory_allocated() / 1e9,
               path="exact" if eng.prompt_buckets is None else "bucketed",
               lengths=heaviest(steps), launches_in_run=in_run)
    if out["requests"] != len(requests):
        raise RuntimeError(f"{label}: served {out['requests']} of "
                           f"{len(requests)} requests")
    print(f"{label} engine ({out['path']} admission, width {width}, max_len "
          f"{max_len}): {out['requests']} requests, {out['tokens']} tokens "
          f"in {out['wall_s']:.3f} s, {out['tok_s']:.1f} tok/s; TTFT p50 "
          f"{out['ttft_p50_ms']:.1f} ms, p99 {out['ttft_p99_ms']:.1f} ms; "
          f"median prefill step {out['prefill_ms']:.3f} ms over "
          f"{out['prefills']}, median decode step {out['decode_ms']:.3f} ms "
          f"over {out['decode_steps']} (CUDA events); peak memory "
          f"{out['peak_gb']:.2f} GB")
    return out | {"done": done}


def lm_model(name, dev, cfg=None):
    """``name``'s model at its full published size (``cfg`` overrides) with
    bf16 weights drawn on ``dev`` from seed ``SEED``."""
    import time

    import torch
    from repro_torch.launch.steps import count_params
    from repro_torch.models import build_model, get_config

    cfg = cfg or get_config(name)
    t0 = time.perf_counter()
    model = build_model(cfg, device=dev)
    params = model.init(seed=SEED, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    print(f"lm {name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads} heads over {cfg.n_kv_heads} kv heads of head_dim "
          f"{cfg.head_dim}, vocab {cfg.vocab}; "
          f"{count_params(cfg) / 1e9:.3f}e9 bf16 parameters drawn on the card "
          f"in "
          f"{time.perf_counter() - t0:.2f} s")
    return model, params


def lm_granite(dev, resources, net, out_dir, cfg=None) -> dict:
    """granite-8b: lm_to_graph's Scission loop, then the engine; returns
    the path's launches, numbers and the lengths of its heaviest decode
    step."""
    import numpy as np
    import torch
    from repro_torch.models.graph_adapter import lm_to_graph
    from repro_torch.serving import Request

    label = "lm granite-8b"
    model, params = lm_model("granite-8b", dev, cfg)
    vocab = model.cfg.vocab
    start = kernel_launches()
    graph = lm_to_graph(model, params, batch=1, seq_len=LM_GRAPH_SEQ)
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    tokens = torch.randint(0, vocab, (1, LM_GRAPH_SEQ), generator=gen,
                           device=dev, dtype=torch.int32)
    print(f"{label} graph: {graph.n_layers} nodes, "
          f"{len(graph.partition_points())} partition points, sequence "
          f"{LM_GRAPH_SEQ}")
    outputs, db = scission_loop("lm-granite", graph, tokens, resources, net,
                                dev, out_dir)
    require_launches(kernel_launches(start, ("flash_attention",)))
    check_replay(label, graph, tokens, dev,
                 kernel_of=lambda n: "flash_attention"
                 if n.kind == "block" else None)
    whole = check_partitions(label, graph, tokens, outputs)
    print(f"{label} graph output {tuple(whole.shape)} {whole.dtype}: equal "
          f"across {list(outputs)} partitions and the whole-graph run; "
          f"finite {bool(torch.isfinite(whole).all())}")
    if not torch.isfinite(whole).all():
        raise RuntimeError(f"{label}: the graph's logits are not finite")
    blocks = {res.name: [r.mean_time_s * 1e3 for r in db.records[res.name]]
              for res in resources}
    del outputs, whole

    e = GRANITE_ENGINE
    rng = np.random.default_rng(SEED)
    requests = [Request(rid=i, prompt=rng.integers(
        0, vocab, int(rng.integers(e["prompt"][0], e["prompt"][1] + 1))),
        max_new_tokens=e["new"]) for i in range(e["requests"])]
    run = serve(label, model, params, requests, e["width"], e["max_len"])
    launches = kernel_launches(start, ("flash_attention",
                                       "decode_attention"))
    require_launches(launches)
    done = run.pop("done")
    check = teacher_forced(label, model, params, done)
    del model, params
    torch.cuda.empty_cache()
    return dict(launches=launches, blocks=blocks, engine=run, check=check,
                lengths=run.pop("lengths"))


def decode_captures():
    """A context manager in which each capture of a decode step as CUDA
    graphs is recorded: it yields the list of (graphs in the chain, SSD
    decode launches inside the capture)."""
    import contextlib

    from repro_torch import _device, tracing

    @contextlib.contextmanager
    def patched():
        real, captures = _device.capture_chain, []

        def counted(*args, **kwargs):
            before = tracing.counters()["ssd_decode_launches"]
            chain = real(*args, **kwargs)
            captures.append((len(chain.graphs), tracing.counters()[
                "ssd_decode_launches"] - before))
            return chain
        _device.capture_chain = counted
        try:
            yield captures
        finally:
            _device.capture_chain = real

    return patched()


def check_captures(label, captures, cfg) -> None:
    """Raises unless there was a capture and each held a graph around each
    shared application's decode_attention cut (one more than the
    applications) and an SSD decode launch per Mamba-2 layer."""
    want = (cfg.n_shared_applications + 1, cfg.n_layers)
    print(f"{label} decode captures (graphs, ssd_decode launches in the "
          f"capture): {captures} (expected {want} each)")
    if not captures or any(c != want for c in captures):
        raise RuntimeError(f"{label}: decode captures {captures}; expected "
                           f"{want[0]} graphs and {want[1]} ssd_decode "
                           f"launches each")


def graphed_tick(label, model, params, width, max_len, lengths) -> dict:
    """The decode step as the engine runs it, over ``width`` slots of
    ``max_len`` whose attention reads ``lengths`` (each slot's cache length
    plus the new token, as :func:`decode_row` takes them), replayed as CUDA
    graphs: its
    device time (``time_ms``, median of ``TICK_RUNS`` replays) with the SSD
    decode kernel, and with :func:`plain_ssd_decode` in its place (the
    plain update and its copy into the cache: the step before the kernel),
    each from a capture of its own over one cache."""
    import contextlib

    import torch
    from repro_torch.launch.steps import make_decode_step
    from repro_torch.models import ssm

    @contextlib.contextmanager
    def plain():
        saved, ssm.ssd_decode = ssm.ssd_decode, plain_ssd_decode
        try:
            yield
        finally:
            ssm.ssd_decode = saved

    gc.collect()
    torch.cuda.empty_cache()
    cache = model.init_cache(batch=width, max_len=max_len)
    token = torch.zeros((width, 1), dtype=torch.int32, device=model.device)
    cache_len = torch.tensor([n - 1 for n in lengths], dtype=torch.int32,
                             device=model.device)
    out = {}
    for name, patch in (("kernel_ms", contextlib.nullcontext()),
                        ("plain_ms", plain())):
        step = make_decode_step(model)
        with patch, torch.no_grad():
            # the first call runs the step eagerly and captures it
            out[name] = time_ms(lambda: step(params, cache, token, cache_len),
                                runs=TICK_RUNS)
        del step
        gc.collect()
    del cache
    torch.cuda.empty_cache()
    print(f"{label} graphed decode tick over {width} slots of {max_len} at "
          f"lengths {min(lengths)}-{max(lengths)}: {out['kernel_ms']:.3f} ms "
          f"with the SSD decode kernel, {out['plain_ms']:.3f} ms with the "
          f"plain update and its copy (device time, median of {TICK_RUNS} "
          f"replays)")
    return out | dict(width=width, max_len=max_len)


def lm_zamba(dev, cfg=None) -> dict:
    """zamba2-2.7b: the engine alone (exact admission), each capture of its
    decode step checked (:func:`check_captures`: 10 graphs, 54 SSD decode
    launches); returns the path's launches, numbers and the lengths of its
    heaviest decode step."""
    import numpy as np
    import torch
    from repro_torch.serving import Request

    label = "lm zamba2-2.7b"
    model, params = lm_model("zamba2-2.7b", dev, cfg)
    e = ZAMBA_ENGINE
    rng = np.random.default_rng(SEED + 1)
    requests = [Request(rid=i, prompt=rng.integers(
        0, model.cfg.vocab, int(rng.choice(e["prompts"]))),
        max_new_tokens=e["new"]) for i in range(e["requests"])]
    start = kernel_launches()
    with decode_captures() as captures:
        run = serve(label, model, params, requests, e["width"], e["max_len"])
    launches = kernel_launches(start, ("flash_attention", "decode_attention",
                                       "ssd_scan", "ssd_decode"))
    require_launches(launches)
    check_captures(label, captures, model.cfg)
    done = run.pop("done")
    if run["path"] != "exact":
        raise RuntimeError(f"{label}: admission was not the exact path")
    check = teacher_forced(label, model, params, done,
                           pad_to=model.cfg.ssm_chunk)
    del model, params
    torch.cuda.empty_cache()
    return dict(launches=launches, engine=run, check=check,
                lengths=run.pop("lengths"))


def lm_zamba2_7b(dev) -> dict:
    """zamba2-7b, the published Zamba2 (81 Mamba-2 layers, two shared
    blocks applied before 13 of them over concat(x, embedding), heads of
    224): the exact engine over ragged prompts, each admission counted (a
    flash launch per shared application and an SSD launch per Mamba-2
    layer) and each decode tick (a decode launch per application), each
    capture of the decode step as CUDA graphs checked
    (:func:`check_captures`), then the teacher-forced check at
    ``ZAMBA2_7B_TOL`` with ``pad_to`` 1: every length prefills as it is;
    then the graphed tick timed at the chat cell's 34 slots
    (:func:`graphed_tick`).  Returns the path's launches, numbers,
    per-step counts and the tick's times."""
    import numpy as np
    import torch
    from repro_torch.serving import Request

    label = "lm zamba2-7b"
    model, params = lm_model("zamba2-7b", dev)
    cfg, e = model.cfg, ZAMBA2_7B_ENGINE
    apps = cfg.n_shared_applications
    rng = np.random.default_rng(SEED + 2)
    requests = [Request(rid=i, prompt=rng.integers(
        0, cfg.vocab, e["prompts"][i % len(e["prompts"])]),
        max_new_tokens=e["new"]) for i in range(e["requests"])]
    start = kernel_launches()
    with decode_captures() as captures:
        run = serve(label, model, params, requests, e["width"], e["max_len"])
    launches = kernel_launches(start, ("flash_attention", "decode_attention",
                                       "ssd_scan", "ssd_decode"))
    require_launches(launches)
    check_captures(label, captures, cfg)
    in_run = run["launches_in_run"]
    per_admission = {"flash_attention": in_run["flash_attention"]
                     / run["prefills"],
                     "ssd_scan": in_run["ssd_scan"] / run["prefills"]}
    per_tick = in_run["decode_attention"] / run["decode_steps"]
    want = {"flash_attention": apps, "ssd_scan": cfg.n_layers}
    print(f"{label} launches in the run: {per_admission['flash_attention']:g}"
          f" flash + {per_admission['ssd_scan']:g} ssd_scan an admission "
          f"over {run['prefills']} admissions, {per_tick:g} decode_attention "
          f"a tick over {run['decode_steps']} ticks (expected {apps} + "
          f"{cfg.n_layers}, {apps})")
    if per_admission != want or per_tick != apps:
        raise RuntimeError(f"{label}: launches a step {per_admission}, "
                           f"{per_tick} a tick; expected {want}, {apps}")
    done = run.pop("done")
    if run["path"] != "exact":
        raise RuntimeError(f"{label}: admission was not the exact path")
    check = teacher_forced(label, model, params, done, tol=ZAMBA2_7B_TOL)
    r = ZAMBA2_7B_ROWS
    tick = graphed_tick(label, model, params, r["width"], r["max_len"],
                        row_lengths())
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    return dict(launches=launches, engine=run, check=check,
                per_admission=per_admission, per_tick=per_tick,
                captures=captures, tick=tick, lengths=run.pop("lengths"))


def flash_hd224_row(dev, launches) -> dict:
    """flash_attention at zamba2-7b's shared attention: q = k = v shapes
    (1, 3468, 32, 224) bf16 (the chat cell's longest prompt), causal,
    against its plain version, timed beside it and causal
    ``scaled_dot_product_attention``; ``launches`` are the zamba2-7b
    path's."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import flash_attention as fa_mod
    from repro_torch.models import get_config

    name = "flash_attention_hd224_zamba2_7b"
    c = get_config("zamba2-7b")
    shape = (1, ZAMBA2_7B_ROWS["prompt"], c.n_heads, c.head_dim)
    gen = torch.Generator(device=dev).manual_seed(SEED + 15)
    q, k, v = (torch.randn(shape, generator=gen, device=dev)
               .to(torch.bfloat16) for _ in range(3))
    got = fa_mod.flash_attention(q, k, v, causal=True)
    qf, kf, vf = q.float(), k.float(), v.float()
    err = check_close(f"{name} vs plain", got,
                      ref.flash_attention_ref(qf, kf, vf, causal=True))

    def call():
        return fa_mod.flash_attention(q, k, v, causal=True)
    ms, call_ms = time_ms(call), time_ms(call, hold=False)
    host = host_ms(call)
    plain_ms = time_ms(lambda: ref.flash_attention_ref(qf, kf, vf,
                                                       causal=True), runs=5)
    del qf, kf, vf
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    lib = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    check_close(f"{name}: SDPA vs the kernel", lib.transpose(1, 2), got)
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True))
    B_, S_, H_, hd = shape
    sass = fa_mod.mma_instances(_build.sass_opcodes("flash_attention"))
    ptxas = fa_mod.mma_instances(_build.ptxas_report("flash_attention"))
    build = mma_build(name, ptxas[hd], sass[hd])
    bq, bk = fa_mod.block_sizes(q, k)
    return dict(
        name=name, tpu="flash_attention.py:122",
        design="mma.sync bf16, causal; head_dim 224 instance",
        build=dict(**build, block_q=bq, block_k=bk),
        shapes=f"q, k, v {shape} bf16, causal=True (zamba2-7b's shared "
               "attention at the chat cell's longest prompt); library: "
               "scaled_dot_product_attention, is_causal",
        err=err, tol=f"tol {TOL} abs + {TOL} rel", ms=ms, call_ms=call_ms,
        host_ms=host, plain_ms=plain_ms,
        flops=2.0 * B_ * H_ * hd * S_ * (S_ + 1),
        nbytes=moved_bytes(q, k, v, got), lib_ms=lib_ms, launches=launches)


def ssd_grouped_row(dev, launches) -> dict:
    """ssd_scan at zamba2-7b's Mamba-2 widths: x (1, 3468, 112, 64) bf16
    (the chat cell's longest prompt, a partial last chunk of 256), b and c
    of 2 groups of 56 heads, N 64, cut from one projection as the block
    hands them over; held against the plain version, equal bit for bit to
    its own launch on the maps copied to each head, and timed beside that
    launch and beside the copy then the launch; ``launches`` are the
    zamba2-7b path's."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import ssd_scan as ssd_mod
    from repro_torch.models import get_config

    name = "ssd_scan_grouped_zamba2_7b"
    c = get_config("zamba2-7b")
    d_inner = c.ssm_expand * c.d_model
    Hn, P, N, G = d_inner // c.ssm_head_dim, c.ssm_head_dim, c.ssm_state, \
        c.ssm_groups
    Sn, chunk = ZAMBA2_7B_ROWS["prompt"], c.ssm_chunk
    gen = torch.Generator(device=dev).manual_seed(SEED + 16)
    x = torch.randn((1, Sn, Hn, P), generator=gen, device=dev) \
        .to(torch.bfloat16)
    la = -F.softplus(torch.randn((1, Sn, Hn), generator=gen, device=dev)) \
        * 0.1
    xbc = torch.randn((1, Sn, d_inner + 2 * G * N), generator=gen,
                      device=dev).to(torch.bfloat16)
    b = xbc[..., d_inner:d_inner + G * N].unflatten(2, (G, N))
    cm = xbc[..., d_inner + G * N:].unflatten(2, (G, N))
    y, fin = ssd_mod.ssd_scan(x, la, b, cm, chunk=chunk)
    args = (x.float(), la, b.float(), cm.float())
    y_ref, fin_ref = ref.ssd_ref(*args, chunk=chunk)
    err = check_close(f"{name} y vs plain", y, y_ref)
    fin_err = check_close(f"{name} final state vs plain", fin, fin_ref)
    del y_ref, fin_ref
    bh, ch = (t.repeat_interleave(Hn // G, dim=2) for t in (b, cm))
    if not all(torch.equal(u, w) for u, w in zip(
            ssd_mod.ssd_scan(x, la, bh, ch, chunk=chunk), (y, fin))):
        raise RuntimeError(f"{name}: the maps copied to each head give "
                           "another result than the groups read by group")

    def call():
        return ssd_mod.ssd_scan(x, la, b, cm, chunk=chunk)
    ms, call_ms = time_ms(call), time_ms(call, hold=False)
    host = host_ms(call)
    per_head_ms = time_ms(lambda: ssd_mod.ssd_scan(x, la, bh, ch,
                                                   chunk=chunk))
    copy_ms = time_ms(lambda: ssd_mod.ssd_scan(
        x, la, b.repeat_interleave(Hn // G, dim=2),
        cm.repeat_interleave(Hn // G, dim=2), chunk=chunk))
    del bh, ch
    plain_ms = time_ms(lambda: ref.ssd_ref(*args, chunk=chunk), runs=5)
    del args
    nc = -(-Sn // chunk)
    tri = chunk * (chunk + 1) // 2
    flops = 2.0 * Hn * nc * (tri * N + tri * P + 2 * chunk * N * P)
    # b and c are views of one projection: each group's map read once
    nbytes = moved_bytes(x, la, y, fin) + 2.0 * b.numel() * b.element_size()
    ws_bytes = ssd_mod.workspace_bytes({"chunk": chunk}, (x.shape, b.shape),
                                       x.dtype)
    passes = {kind: ssd_mod.mma_passes(report("ssd_scan"), P, la.dtype)
              for kind, report in (("ptxas", _build.ptxas_report),
                                   ("sass", _build.sass_opcodes))}
    build = mma_build(name, sum(passes["ptxas"].values(), []),
                      sum(passes["sass"].values(), []))
    return dict(
        name=name, tpu="ssd_scan.py:93",
        design="mma.sync bf16, chunk-parallel 3-pass; b, c read by group",
        build=dict(**build, workspace_bytes=ws_bytes,
                   per_head_ms=per_head_ms, copy_then_scan_ms=copy_ms),
        shapes=f"x {tuple(x.shape)} bf16, b, c {tuple(b.shape)} bf16 views "
               f"of one projection ({Hn // G} heads a group), log_a fp32, "
               f"chunk={chunk} (last chunk {Sn - (nc - 1) * chunk} of "
               f"{chunk}); final-state max abs err {fin_err:.4g}; maps "
               f"copied to each head: the same output, {per_head_ms:.4f} "
               f"ms, {copy_ms:.4f} ms with the copy",
        err=err, tol=f"tol {TOL} abs + {TOL} rel", ms=ms, call_ms=call_ms,
        host_ms=host, plain_ms=plain_ms, flops=flops, nbytes=nbytes,
        lib_ms=None, launches=launches)


# the SSD decode's new state takes the plain version's roundings (two
# products and their sum, no FMA), so only expf's last bits could part them
SSD_DECODE_TOL = 1e-6


def ssd_decode_row(dev, name, B, H, G, N, P, launches,
                   launches_of=None) -> dict:
    """The SSD decode kernel at B rows of H heads, b and c of G groups of
    N, P columns: an fp32 state, x in bf16, b and c cut from one
    projection as the blocks hand them over, the state updated in place as
    the decode step runs it.  Held against the plain version (y at
    ``TOL``, the state at ``SSD_DECODE_TOL``; with one group, also bit for
    bit against the call on b and c as stride-0 views over the heads),
    timed beside it with the
    copy into the state it made (the step before the kernel); the bound
    is the state read once and written once, beside x, b, c and y."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import ssd_scan as ssd_mod

    gen = torch.Generator(device=dev).manual_seed(SEED + 17)
    state = torch.randn((B, H, N, P), generator=gen, device=dev)
    x = torch.randn((B, 1, H, P), generator=gen, device=dev) \
        .to(torch.bfloat16)
    la = -F.softplus(torch.randn((B, 1, H), generator=gen, device=dev))
    bc = torch.randn((B, 1, 2 * G * N), generator=gen, device=dev) \
        .to(torch.bfloat16)
    b, c = (bc[..., i * G * N:(i + 1) * G * N].unflatten(2, (G, N))
            for i in range(2))
    y_ref, st_ref = ref.ssd_decode_ref(state, x, la, b, c)
    before = state.clone() if G == 1 else None
    y, st = ssd_mod.ssd_decode(state, x, la, b, c, out=state)
    err = check_close(f"{name} y vs plain", y, y_ref)
    st_err = check_close(f"{name} state vs plain", st, st_ref,
                         atol=SSD_DECODE_TOL, rtol=SSD_DECODE_TOL)
    del y_ref, st_ref
    if before is not None:
        # one map for every head, as a stride-0 view over the heads (G = H
        # with a head stride of 0): the same sums, bit for bit
        wide = [t.expand(B, 1, H, N) for t in (b, c)]
        y_w, st_w = ssd_mod.ssd_decode(before, x, la, *wide, out=before)
        if not (torch.equal(y_w, y) and torch.equal(st_w, st)):
            raise RuntimeError(f"{name}: the stride-0 view of the one map "
                               f"differs from the grouped call")
        print(f"{name}: b and c as a stride-0 view over the {H} heads equal "
              f"the grouped call bit for bit")
        del before, y_w, st_w

    def call():
        return ssd_mod.ssd_decode(state, x, la, b, c, out=state)

    def plain():
        state.copy_(ref.ssd_decode_ref(state, x, la, b, c)[1])
    ms, call_ms = time_ms(call), time_ms(call, hold=False)
    host = host_ms(call)
    plain_ms = time_ms(plain, runs=10)
    nbytes = 2.0 * state.numel() * state.element_size() + \
        moved_bytes(x, la, y) + 2.0 * b.numel() * b.element_size()
    tile = ssd_mod.decode_tile(B, H, P)
    ptxas = [v for k, v in _build.ptxas_report("ssd_scan").items()
             if "ssd_decode_kernel" in k and "bfloat16" in k]
    return dict(
        name=name, tpu="ssd_scan", replaces="none: the reference's "
        "ssd_decode_step (src/repro/models/ssm.py:118) is plain jnp",
        design="SIMT fp32, in place: a CTA per (row, head, P tile), 16-byte "
               "lanes along P, row groups over N, y summed in shared memory",
        build=dict(registers=max(e["registers"] for e in ptxas),
                   spill_stores=max(e["spill_stores"] for e in ptxas),
                   tile=tile, ctas=B * H * -(-P // tile)),
        shapes=f"state {tuple(state.shape)} fp32 in place, x "
               f"{tuple(x.shape)} bf16, b, c {tuple(b.shape)} bf16 views of "
               f"one projection ({H // G} heads a group), log_a fp32; "
               f"state max abs err {st_err:.4g} (tol {SSD_DECODE_TOL}); "
               f"plain: the plain version and its copy into the state",
        err=err, tol=f"tol {TOL} abs + {TOL} rel", ms=ms, call_ms=call_ms,
        host_ms=host, plain_ms=plain_ms, flops=4.0 * B * H * N * P,
        nbytes=nbytes, lib_ms=None, launches=launches,
        **({"launches_of": launches_of} if launches_of else {}))


def row_lengths() -> list[int]:
    """The cache lengths of the zamba2-7b chat cell's 34 slots that its
    decode row and its graphed tick read, drawn in ``ZAMBA2_7B_ROWS``'s
    range from seed ``SEED + 3``."""
    import numpy as np

    r = ZAMBA2_7B_ROWS
    gen = np.random.default_rng(SEED + 3)
    return [int(n) for n in gen.integers(*r["lengths"], r["width"])]


def zamba2_7b_rows(dev, zamba7) -> list:
    """The rows of the kernels' head-224 and grouped instances and of the
    SSD decode at the zamba2-7b chat cell's shapes, each with the launches
    of :func:`lm_zamba2_7b`'s run; the SSD decode's row carries the
    graphed tick's times."""
    from repro_torch.models import get_config

    c, r = get_config("zamba2-7b"), ZAMBA2_7B_ROWS
    Hn = c.ssm_expand * c.d_model // c.ssm_head_dim
    lengths = row_lengths()
    launches = zamba7["launches"]
    return [
        flash_hd224_row(dev, launches["flash_attention"]),
        decode_row("decode_attention_hd224_zamba2_7b",
                   "mma.sync bf16, split-KV, one wave; head_dim 224 "
                   "instance", dev, r["width"], r["max_len"], c.n_heads,
                   c.n_kv_heads, c.head_dim, lengths, None,
                   launches["decode_attention"],
                   launches_of=f"the zamba2-7b engine at width "
                               f"{ZAMBA2_7B_ENGINE['width']}, not these "
                               f"widths"),
        ssd_grouped_row(dev, launches["ssd_scan"]),
        ssd_decode_row(dev, "ssd_decode_zamba2_7b", r["width"], Hn,
                       c.ssm_groups, c.ssm_state, c.ssm_head_dim,
                       launches["ssd_decode"],
                       launches_of=f"the zamba2-7b engine at width "
                                   f"{ZAMBA2_7B_ENGINE['width']}, not "
                                   f"these widths")
        | {"tick": zamba7["tick"]},
    ]


def lm_example(dev) -> dict:
    """examples/partition_and_serve_torch.py's four steps on its reduced
    gemma2 (local layers with a window of 16, outgrown by its sequences),
    then the teacher-forced check of its engine's tokens: returns the
    path's launches, the model's widths and the lengths of the engine's
    heaviest decode step."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "partition_and_serve_torch",
        ROOT / "examples" / "partition_and_serve_torch.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    start = kernel_launches()
    cwd = os.getcwd()
    os.chdir(ROOT)
    try:
        with decode_lengths() as steps:
            model, params, eng, done = example.main(["--device", str(dev)])
    finally:
        os.chdir(cwd)
    launches = kernel_launches(start, ("flash_attention",
                                       "decode_attention"))
    require_launches(launches)
    check = teacher_forced("lm example", model, params, done)
    return dict(launches=launches, check=check, cfg=model.cfg,
                width=eng.width, max_len=eng.max_len,
                lengths=heaviest(steps))


# -- the other model families: MoE, xLSTM, enc-dec, VLM ----------------------
# qwen2-moe-a2.7b: moe_to_graph's DAG Scission loop over layer 0's MoE at
# MOE_GRAPH_SEQ tokens, then the bucketed engine; xlstm-125m: the DAG loop
# over xlstm_to_graph, then the exact engine; whisper-medium: prefill and
# greedy decode over synthetic frames, then the DAG loop over
# encdec_to_graph; internvl2-76b's backbone at full width, depth cut to
# INTERNVL_LAYERS of its 80 layers, over synthetic patch embeddings.
MOE_GRAPH_SEQ = 2048
QWEN_ENGINE = dict(width=8, max_len=2048, requests=16, prompt=(64, 1024),
                   new=32)
XLSTM_GRAPH_SEQ = 2048
XLSTM_ENGINE = dict(width=4, max_len=1024, requests=8,
                    prompts=(128, 256, 512), new=16)
WHISPER = dict(batch=8, prompt=4, new=32, max_len=448, graph_seq=448,
               enc_splits=2)
INTERNVL_LAYERS = 8
INTERNVL = dict(batch=4, tokens=256, new=16)
# engine against the same engine with the plain versions (MoE, xLSTM),
# decided before the first run on the card: the kernel run's logits at
# every generated position within ENGINE_TOL (relative norm) of the plain
# run's, the plain run fed the kernel run's tokens; each kernel-run token
# equal to the plain argmax wherever the plain top-2 margin exceeds
# ENGINE_MARGIN x the request's largest logit difference
ENGINE_TOL = 0.1
ENGINE_MARGIN = 2.0


def dag_scission_loop(label, graph, x, resources, net, dev) -> dict:
    """Scission's loop over a branchy graph: fuse it with
    ``fuse_block_dag``, time every block on every resource as CUDA-graph
    replays, query through the SP solver, and run the best partition, the
    best one over more than one resource and the blocks on the resources in
    turn (every block edge crossing, branch and skip edges too) with
    ``DagPipelineExecutor``; each partitioned output must equal the
    whole-graph run bit for bit.  Prints and returns the block times, the
    chosen partition and the wall time of each step."""
    import torch

    import repro_torch.core.query as query_mod
    from repro_torch.core import (PartitionConfig, Query, Scission, Segment,
                                  TimingProvider, fuse_blocks)
    from repro_torch.runtime import DagPipelineExecutor

    t0 = time.perf_counter()
    whole = run_blocks([b.make_callable() for b in fuse_blocks(graph)],
                       x)[-1]
    t_whole = time.perf_counter() - t0
    t0 = time.perf_counter()
    s = Scission(resources=resources, network=net, source="edge1",
                 provider=TimingProvider(device=dev), runs=5, device=dev)
    db = s.benchmark(graph, dag=True)
    dag = s._dags[graph.name]
    t_bench = time.perf_counter() - t0
    old = query_mod.EXHAUSTIVE_LIMIT
    query_mod.EXHAUSTIVE_LIMIT = -1           # the SP lattice, not the oracle
    try:
        res = s.query(graph.name, Query(top_n=20),
                      float(x.numel() * x.element_size()))
    finally:
        query_mod.EXHAUSTIVE_LIMIT = old
    t1 = time.perf_counter()
    staged = next((c for c in res.configs if len(set(c.assignment)) > 1),
                  None)
    interleaved = PartitionConfig(graph.name, tuple(
        Segment(resources[i % 2].name, i, i) for i in range(len(dag))),
        0.0, {}, 0.0, 0.0)
    runs = []
    for name, cfg in (("best", res.best), ("staged", staged),
                      ("interleaved", interleaved)):
        if cfg is None:
            continue
        pipe = DagPipelineExecutor(graph, cfg, net, source="edge1",
                                   device=dev)
        y, timings = pipe.run(x, collect_timing=True)
        if y.shape != whole.shape or not torch.equal(y, whole):
            raise RuntimeError(f"{label}: the {name} DAG partition differs "
                               "from the whole-graph run")
        runs.append(name)
    if not torch.isfinite(whole.float()).all():
        raise RuntimeError(f"{label}: the graph's output is not finite")
    blocks = {r.name: [b.mean_time_s * 1e3 for b in db.records[r.name]]
              for r in resources}
    for r in resources:
        print(f"{label} db {r.name}: " + ", ".join(
            f"{blk.name} {t:.3f} ms" for blk, t in zip(dag, blocks[r.name])))
    print(f"{label} DAG: {len(graph.nodes)} nodes, {len(dag)} blocks, "
          f"{len(dag.parallel_regions)} parallel regions; query "
          f"{res.strategy} {res.query_time_s * 1e3:.1f} ms, best "
          f"{res.best.describe()[:160]}; partitions {runs} equal the "
          f"whole graph bit for bit; whole-graph run {t_whole:.1f} s, "
          f"benchmark {t_bench:.1f} s, partitioned runs "
          f"{time.perf_counter() - t1:.1f} s of wall time")
    return dict(blocks=blocks, best=res.best.describe(), runs=runs,
                dag_blocks=len(dag))


def _routes(log, forced=None):
    """A context manager that records each MoE layer's top-k expert ids,
    in call order, in ``log["routes"]``; with ``forced`` (another run's
    log) each call routes to that run's experts instead, weighted by this
    run's own gates."""
    import contextlib

    import torch
    from repro_torch.models import moe as moe_mod

    @contextlib.contextmanager
    def patched():
        real = moe_mod._route

        def route(p, xt, *, top_k, n_experts):
            probs, vals, idx = real(p, xt, top_k=top_k, n_experts=n_experts)
            i = len(log["routes"])
            log["routes"].append(idx.cpu())
            if forced is not None:
                idx = forced["routes"][i].to(idx.device)
                vals = torch.gather(probs, -1, idx)
                vals = vals / vals.sum(dim=-1, keepdim=True).clamp(min=1e-9)
            return probs, vals, idx

        moe_mod._route = route
        try:
            yield log
        finally:
            moe_mod._route = real

    return patched()


def _route_differ(a, b) -> tuple[int, int]:
    """(routings whose top-k expert set differs, routings) between two
    runs' ``_routes`` logs."""
    routed = differ = 0
    for x, y in zip(a, b):
        routed += x.shape[0] * x.shape[1]
        differ += int((x.sort(dim=-1).values != y.sort(dim=-1).values)
                      .any(dim=-1).sum())
    return differ, routed


def _eager_decode(model):
    """``make_decode_step``'s step, run eagerly: the model's decode step
    and its greedy next token."""
    import torch

    def decode(p, cache, token, lengths):
        logits, cache = model.decode_step(p, token, cache, lengths)
        nxt = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
        return nxt, logits, cache

    return decode


def engine_vs_plain(label, model, params, requests, width, max_len) -> dict:
    """The engine's tokens held against the same engine with the kernels'
    plain versions (``_plain_kernels``), as ``forward`` cannot hold them
    for models whose served computation differs from ``forward`` by the
    reference's own semantics (MoE capacity per bucket's groups, the
    sLSTM's stabiliser starting at 0 in prefill): the same requests and
    schedule, the plain run fed the kernel run's tokens (its first token
    from the kernel run's prefill logits, its decode outputs replaced by
    the kernel run's), so both see the same inputs at every step.  An MoE
    layer of the plain run routes to the kernel run's experts, weighted by
    its own gates (``_routes``): a near tie that bf16 noise breaks the
    other way would otherwise send a token through other experts, a
    discrete change that later layers amplify, which says nothing of the
    kernels.  For an MoE model a second plain run routes by its own
    router; its error and the (token, layer) routings whose top-k set
    differs from the kernel run's are printed beside the checked reading,
    not checked.  Raises unless each request's logits at its generated
    positions agree within ``ENGINE_TOL`` (relative norm) and every
    kernel-run token equals the plain argmax where the plain top-2 margin
    exceeds ``ENGINE_MARGIN`` x the request's largest logit difference
    (``_hold``)."""
    import torch
    from repro_torch.serving import ServingEngine

    def run(forced=None, route=True):
        log = dict(first={}, steps=[], routes=[])
        eng = ServingEngine(model, params, width=width, max_len=max_len)
        for r in requests():
            eng.submit(r)
        prefill, decode, admit = eng._prefill, eng._decode, eng._admit_exact
        if model.cfg.moe_experts:
            # the routing log reads each MoE call's experts on the host,
            # which a replay of the graphed decode step never calls: these
            # decode steps run eagerly
            decode = _eager_decode(model)

        def admit_logged(req, slot):
            log["admitting"] = req.rid
            return admit(req, slot)

        def prefill_logged(p, cache, batch):
            logits, cache = prefill(p, cache, batch)
            i = len(log["first"])
            # the exact path's first token comes from these logits
            log["first"][i] = (log.pop("admitting", None),
                               logits[:, -1].float().cpu())
            if forced is not None:
                logits = forced["first"][i][1][:, None]
            return logits, cache

        def decode_logged(p, cache, token, lengths):
            nxt, logits, cache = decode(p, cache, token, lengths)
            active = {s: r.rid for s, r in eng.active.items()}
            i = len(log["steps"])
            log["steps"].append((active, logits[:, -1].float().cpu(),
                                 nxt.cpu()))
            if forced is not None:
                nxt = forced["steps"][i][2].to(nxt.device)
            return nxt, logits, cache

        eng._prefill, eng._decode = prefill_logged, decode_logged
        eng._admit_exact = admit_logged
        with _routes(log, forced if route else None):
            done = eng.run()
        log["done"] = {r.rid: r for r in done}
        return log

    def per_request(want):
        """Each request's logits at its generated positions, in order, in
        the kernel run and in ``want``: the exact path's first token from
        its prefill, then its decode steps."""
        if len(got["steps"]) != len(want["steps"]):
            raise RuntimeError(f"{label}: the plain run took another "
                               "schedule")
        per = {rid: ([], []) for rid in got["done"]}
        for i, (rid, g_log) in sorted(got["first"].items()):
            if rid is not None:
                per[rid][0].append(g_log[0])
                per[rid][1].append(want["first"][i][1][0])
        for (active, g_log, _), (w_active, w_log, _) in zip(got["steps"],
                                                             want["steps"]):
            if active != w_active:
                raise RuntimeError(f"{label}: the plain run took another "
                                   "schedule")
            for slot, rid in active.items():
                per[rid][0].append(g_log[slot])
                per[rid][1].append(w_log[slot])
        return {rid: (torch.stack(g), torch.stack(w))
                for rid, (g, w) in sorted(per.items())}

    with torch.no_grad():
        got = run()
        with _plain_kernels():
            want = run(forced=got)
            free = run(forced=got, route=False) if got["routes"] else None
    holds = []
    for rid, (g, w) in per_request(want).items():
        toks = got["done"][rid].tokens
        if len(toks) != len(g):
            raise RuntimeError(f"{label} request {rid}: {len(toks)} tokens "
                               f"for {len(g)} logged positions")
        holds.append(_hold(label, rid, g, w, toks, ENGINE_TOL,
                           ENGINE_MARGIN))
    note, extra = "", {}
    if free is not None:
        differ, routed = _route_differ(got["routes"], free["routes"])
        free_rel = max((torch.linalg.vector_norm(g - w)
                        / torch.linalg.vector_norm(w)).item()
                       for g, w in per_request(free).values())
        note = (f"; plain routed as the kernel run (checked) beside plain "
                f"routed by its own router: relative norm error up to "
                f"{free_rel:.4g} (not checked), top-k expert sets differ at "
                f"{differ} of {routed} (token, layer) routings over "
                f"{len(got['routes'])} MoE calls, bucket padding included")
        extra = dict(free_rel=free_rel, route_differ=differ, routed=routed)
    return _holds(label, "engine vs plain engine", holds, ENGINE_TOL,
                  ENGINE_MARGIN, note) | extra


def error_by_layer(label, model, params, tokens) -> dict:
    """Where an MoE model's error against its plain versions arises and
    grows: ``tokens`` (1, S) through ``forward`` with the kernels, then with
    the plain versions routed as the kernel run (``_routes``), routed by
    their own router, and routed as the kernel run under two faults of the
    attention that the engine check must see: q, k and v rounded to fp8
    (e4m3) before it (a lower-precision kernel), and each query's own key
    replaced by its predecessor (an off-by-one in the cache's rows).
    Prints the residual stream's relative norm error against the kernel
    run after each layer group, and the logits' over all positions; returns
    the logits' errors.  Nothing here is checked."""
    import contextlib

    import torch
    from repro_torch.models import layers as L

    hiddens = []
    real_group = model._apply_group

    def group(*args, **kwargs):
        out = real_group(*args, **kwargs)
        hiddens[-1].append(out[0].float())
        return out

    def run(forced=None):
        log = dict(routes=[])
        hiddens.append([])
        with torch.no_grad(), _routes(log, forced):
            hidden, _ = model.forward(params, tokens)
            log["logits"] = L.unembed(params["embed"], hidden,
                                      softcap=model.cfg.final_softcap)[0] \
                .float()
        log["hidden"] = hiddens.pop()
        return log

    @contextlib.contextmanager
    def faulty(fault):
        plain = L.flash_attention

        def attention(q, k, v, **kw):
            if fault == "fp8":
                q, k, v = (t.to(torch.float8_e4m3fn).to(t.dtype)
                           for t in (q, k, v))
            else:
                k, v = (torch.cat([t[:, :1], t[:, :-1]], dim=1)
                        for t in (k, v))
            return plain(q, k, v, **kw)

        L.flash_attention = attention
        try:
            yield
        finally:
            L.flash_attention = plain

    def rel(a, b):
        return (torch.linalg.vector_norm(a - b)
                / torch.linalg.vector_norm(b)).item()

    model._apply_group = group
    try:
        got = run()
        with _plain_kernels():
            runs = {"routed as the kernel run": run(forced=got),
                    "own router": run()}
            for fault in ("fp8", "off-by-one"):
                with faulty(fault):
                    runs[f"routed as the kernel run, {fault} attention"] = \
                        run(forced=got)
    finally:
        del model._apply_group
    out = {}
    for name, want in runs.items():
        layers = [rel(g, w) for g, w in zip(got["hidden"], want["hidden"])]
        out[name] = rel(got["logits"], want["logits"])
        differ, routed = _route_differ(got["routes"], want["routes"])
        print(f"{label} forward of {tokens.shape[1]} tokens, kernels vs "
              f"plain {name}: logits' relative norm error {out[name]:.4g}; "
              f"top-k sets differ at {differ} of {routed}; residual stream "
              f"after each layer: " + ", ".join(f"{e:.3g}" for e in layers))
    return out


def _requests(vocab, spec, seed):
    """The engine's seeded requests: prompt lengths uniform in
    ``spec["prompt"]`` or drawn from ``spec["prompts"]``."""
    import numpy as np
    from repro_torch.serving import Request
    rng = np.random.default_rng(seed)

    def length():
        if "prompts" in spec:
            return int(rng.choice(spec["prompts"]))
        return int(rng.integers(spec["prompt"][0], spec["prompt"][1] + 1))

    return [Request(rid=i, prompt=rng.integers(0, vocab, length()),
                    max_new_tokens=spec["new"])
            for i in range(spec["requests"])]


def lm_qwen_moe(dev, resources, net, cfg=None) -> dict:
    """qwen2-moe-a2.7b: moe_to_graph's DAG loop over layer 0's MoE, then
    the bucketed engine and the engine-against-plain check; returns the
    path's launches, numbers and its heaviest decode step's lengths."""
    import numpy as np
    import torch
    from repro_torch.models.graph_adapter import moe_to_graph

    label = "lm qwen2-moe-a2.7b"
    model, params = lm_model("qwen2-moe-a2.7b", dev, cfg)
    c = model.cfg
    start = kernel_launches()
    moe_p = {k: v[0] for k, v in
             params["layers"]["s1_moe"]["moe"].items() if k != "shared"}
    graph = moe_to_graph(moe_p, batch=1, seq_len=MOE_GRAPH_SEQ,
                         d_model=c.d_model, n_experts=c.moe_experts,
                         top_k=c.moe_top_k, n_shards=2,
                         activation=c.activation, name="qwen2-moe-layer0")
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    acts = torch.randn((1, MOE_GRAPH_SEQ, c.d_model), generator=gen,
                       device=dev).to(torch.bfloat16)
    graph_run = dag_scission_loop("lm-qwen2-moe", graph, acts, resources,
                                  net, dev)
    del graph, acts
    requests = lambda: _requests(c.vocab, QWEN_ENGINE, SEED + 2)  # noqa
    e = QWEN_ENGINE
    run = serve(label, model, params, requests(), e["width"], e["max_len"])
    launches = kernel_launches(start, ("flash_attention",
                                       "decode_attention"))
    require_launches(launches)
    run.pop("done")
    check = engine_vs_plain(label, model, params, requests, e["width"],
                            e["max_len"])
    # the requests' prompts, joined, cut to the longest prompt's bound in
    # whole MoE groups
    n = e["prompt"][1] // c.moe_group_size * c.moe_group_size
    joined = np.concatenate([r.prompt for r in requests()])[:n]
    split = error_by_layer(label, model, params, torch.as_tensor(
        joined, dtype=torch.int32, device=dev)[None])
    del model, params
    torch.cuda.empty_cache()
    return dict(launches=launches, graph=graph_run, engine=run, check=check,
                split=split, lengths=run.pop("lengths"))


def lm_xlstm(dev, resources, net, cfg=None) -> dict:
    """xlstm-125m: xlstm_to_graph's DAG loop, then the exact engine and the
    engine-against-plain check; returns the path's launches (the SSD's
    wide route's among them) and numbers."""
    import torch
    from repro_torch.models.graph_adapter import xlstm_to_graph

    label = "lm xlstm-125m"
    model, params = lm_model("xlstm-125m", dev, cfg)
    c = model.cfg
    start = kernel_launches()
    t0 = time.perf_counter()
    graph = xlstm_to_graph(model, params, batch=1, seq_len=XLSTM_GRAPH_SEQ)
    print(f"{label} graph built and traced in "
          f"{time.perf_counter() - t0:.1f} s")
    gen = torch.Generator(device=dev).manual_seed(SEED + 10)
    tokens = torch.randint(0, c.vocab, (1, XLSTM_GRAPH_SEQ), generator=gen,
                           device=dev, dtype=torch.int32)
    graph_run = dag_scission_loop("lm-xlstm", graph, tokens, resources, net,
                                  dev)
    del graph, tokens
    n = kernel_launches(start)
    dag = {"ssd_scan (DAG loop)": n["ssd_scan"],
           "ssd_scan wide route (DAG loop)": n["ssd_scan wide route"]}
    require_launches(dag)
    requests = lambda: _requests(c.vocab, XLSTM_ENGINE, SEED + 3)  # noqa
    e = XLSTM_ENGINE
    t0 = time.perf_counter()
    start = kernel_launches()
    run = serve(label, model, params, requests(), e["width"], e["max_len"])
    if run["path"] != "exact":
        raise RuntimeError(f"{label}: admission was not the exact path")
    n = kernel_launches(start)
    launches = {"ssd_scan (engine)": n["ssd_scan"],
                "ssd_scan wide route (engine)": n["ssd_scan wide route"],
                "ssd_decode (engine)": n["ssd_decode"],
                "ssd_scan wide route (engine's run, warm-up excluded)":
                    run["launches_in_run"]["ssd_scan wide route"]}
    require_launches(launches)
    launches = dag | launches
    run.pop("done")
    t1 = time.perf_counter()
    check = engine_vs_plain(label, model, params, requests, e["width"],
                            e["max_len"])
    print(f"{label}: engine with its warm-up {t1 - t0:.1f} s, engine vs "
          f"plain {time.perf_counter() - t1:.1f} s of wall time")
    del model, params
    torch.cuda.empty_cache()
    return dict(launches=launches, graph=graph_run, engine=run, check=check)


def _route_counter(module, name, counts, key_of):
    """``module.<name>`` (a kernel entry point a model calls) wrapped so
    that each call adds the launches it made, read from ``tracing``'s
    ``<name>_launches`` counter, to ``counts[key_of(args, kwargs)]``;
    returns the original."""
    from repro_torch import tracing
    real = getattr(module, name)
    counter = f"{name}_launches"

    def counted(*args, **kwargs):
        before = tracing.counters()[counter]
        out = real(*args, **kwargs)
        counts[key_of(args, kwargs)] += tracing.counters()[counter] - before
        return out

    setattr(module, name, counted)
    return real


def lm_whisper(dev, resources, net, cfg=None) -> dict:
    """whisper-medium: ``make_prefill_step`` over synthetic frames and a
    prompt, greedy ``make_decode_step`` s, the teacher-forced check, then
    encdec_to_graph's DAG loop; returns the launches by route (flash causal
    and non-causal, decode over the self and the cross cache) and the
    numbers."""
    import types

    import torch
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import encdec, vision
    from repro_torch.models import layers as L
    from repro_torch.models.graph_adapter import encdec_to_graph

    label = "lm whisper-medium"
    model, params = lm_model("whisper-medium", dev, cfg)
    c, w = model.cfg, WHISPER
    frames = vision.synthetic_embeds(
        SEED + 7, vision.frame_embed_spec(w["batch"], c.encoder_len,
                                          c.d_model), device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    prompt = torch.randint(0, c.vocab, (w["batch"], w["prompt"]),
                           generator=gen, device=dev, dtype=torch.int32)
    routes = Counter()
    saved = [(encdec, "flash_attention", _route_counter(
                 encdec, "flash_attention", routes,
                 lambda a, k: "flash non-causal")),
             (L, "flash_attention", _route_counter(
                 L, "flash_attention", routes,
                 lambda a, k: "flash causal" if k.get("causal", True)
                 else "flash non-causal")),
             (encdec, "decode_attention", _route_counter(
                 encdec, "decode_attention", routes,
                 lambda a, k: "decode cross")),
             (L, "decode_attention", _route_counter(
                 L, "decode_attention", routes,
                 lambda a, k: "decode self"))]
    start = kernel_launches()
    prefill, decode = StepClock(), StepClock()
    step_p = prefill.wrap(make_prefill_step(model))
    step_d = decode.wrap(make_decode_step(model))
    try:
        with torch.no_grad():
            cache = model.init_cache(w["batch"], w["max_len"])
            logits, cache = step_p(params, cache, {"tokens": prompt,
                                                   "frames": frames})
            tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
            out = [tok]
            clen = torch.full((w["batch"],), w["prompt"], dtype=torch.int32,
                              device=dev)
            for _ in range(w["new"] - 1):
                tok, _, cache = step_d(params, cache, tok, clen)
                out.append(tok)
                clen = clen + 1
        # the last step's self-attention lengths (the heaviest): its cache
        # length plus one
        last = clen.tolist()
        torch.cuda.synchronize()
    finally:
        for module, name, real in saved:
            setattr(module, name, real)
    launches = {**kernel_launches(start, ("flash_attention",
                                          "decode_attention")),
                **dict(routes)}
    require_launches(launches)
    gen_toks = torch.cat(out, dim=1).cpu().numpy()
    p_ms, d_ms = prefill.ms(), decode.ms()
    print(f"{label}: prefill step ({w['batch']} x {c.encoder_len} frames, "
          f"{w['prompt']}-token prompts) {p_ms[0]:.3f} ms; decode step "
          f"median {statistics.median(d_ms):.3f} ms over {len(d_ms)} "
          f"(CUDA events); {gen_toks.shape[1]} tokens a sequence; "
          f"launches by route {dict(routes)}")
    del cache
    done = [types.SimpleNamespace(rid=b, prompt=prompt[b].cpu().numpy(),
                                  tokens=list(gen_toks[b]))
            for b in range(w["batch"])]
    check = teacher_forced(label, model, params, done,
                           inputs=lambda r: {"frames":
                                             frames[r.rid:r.rid + 1]})
    del frames
    graph = encdec_to_graph(model, params, batch=1, seq_len=w["graph_seq"],
                            enc_splits=w["enc_splits"])
    tokens = torch.randint(0, c.vocab, (1, w["graph_seq"]), generator=gen,
                           device=dev, dtype=torch.int32)
    graph_run = dag_scission_loop("lm-whisper", graph, tokens, resources,
                                  net, dev)
    del model, params, graph
    torch.cuda.empty_cache()
    return dict(launches=launches, graph=graph_run, check=check,
                prefill_ms=p_ms[0], decode_ms=statistics.median(d_ms),
                lengths=last)


def lm_internvl(dev, cfg=None) -> dict:
    """internvl2-76b's backbone at full width, depth cut to
    ``INTERNVL_LAYERS`` layers: one prefill over synthetic patch
    embeddings plus tokens, greedy decode steps, the teacher-forced check;
    returns the launches and numbers."""
    import types

    import torch
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import get_config, vision

    label = "lm internvl2-76b"
    full = get_config("internvl2-76b")
    cfg = cfg or full.replace(n_layers=INTERNVL_LAYERS)
    print(f"{label} reduced: depth {cfg.n_layers} of {full.n_layers} "
          "layers (one card's time and memory); widths as published")
    model, params = lm_model("internvl2-76b", dev, cfg)
    c, v = model.cfg, INTERNVL
    patches = vision.synthetic_embeds(
        SEED + 8, vision.patch_embed_spec(v["batch"], c.n_img_tokens,
                                          c.d_model), device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 12)
    prompt = torch.randint(0, c.vocab, (v["batch"], v["tokens"]),
                           generator=gen, device=dev, dtype=torch.int32)
    start = kernel_launches()
    prefill, decode = StepClock(), StepClock()
    step_p = prefill.wrap(make_prefill_step(model))
    step_d = decode.wrap(make_decode_step(model))
    n0 = c.n_img_tokens + v["tokens"]
    with torch.no_grad():
        cache = model.init_cache(v["batch"], n0 + v["new"])
        logits, cache = step_p(params, cache, {"tokens": prompt,
                                               "patch_embeds": patches})
        tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
        out = [tok]
        clen = torch.full((v["batch"],), n0, dtype=torch.int32, device=dev)
        for _ in range(v["new"] - 1):
            tok, _, cache = step_d(params, cache, tok, clen)
            out.append(tok)
            clen = clen + 1
    # the last step's lengths (the heaviest): its cache length plus one
    last = clen.tolist()
    torch.cuda.synchronize()
    launches = kernel_launches(start, ("flash_attention",
                                       "decode_attention"))
    require_launches(launches)
    p_ms, d_ms = prefill.ms(), decode.ms()
    print(f"{label}: prefill step ({v['batch']} x ({c.n_img_tokens} patch "
          f"embeddings + {v['tokens']} tokens)) {p_ms[0]:.3f} ms; decode "
          f"step median {statistics.median(d_ms):.3f} ms over {len(d_ms)} "
          f"(CUDA events); peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    del cache
    gen_toks = torch.cat(out, dim=1).cpu().numpy()
    done = [types.SimpleNamespace(rid=b, prompt=prompt[b].cpu().numpy(),
                                  tokens=list(gen_toks[b]))
            for b in range(v["batch"])]
    check = teacher_forced(label, model, params, done,
                           inputs=lambda r: {"patch_embeds":
                                             patches[r.rid:r.rid + 1]},
                           prefix=c.n_img_tokens)
    del model, params, patches
    torch.cuda.empty_cache()
    return dict(launches=launches, check=check, prefill_ms=p_ms[0],
                decode_ms=statistics.median(d_ms), layers=cfg.n_layers,
                max_len=n0 + v["new"], lengths=last)


# ssd_scan's wide route before its redesign for Hopper (mma.sync, three
# passes, the chunk states crossing memory four times): CUDA-event device
# time in ms by shape (B, S, H, P), NVIDIA H100 80GB HBM3 at 700 W; the lm
# path's shape from PERF.md's kernel table, the train path's from
# ssd_wide_times on that kernel (PERF.md's findings on the wide route)
SSD_WIDE_EARLIER_MS = {(1, 2048, 4, 384): 0.1776, (8, 512, 4, 384): 0.3772}


def ssd_wide_inputs(dev, batch=1, seq=None):
    """xlstm-125m's mLSTM inputs to ssd_scan, (batch, seq, 4, 384) bf16
    (the lm path's (1, 2048) unless given), from the seed: x = v
    sigmoid(i), b = k / sqrt(384), c = q, log_a = log sigmoid(f) in
    fp32."""
    import torch
    import torch.nn.functional as F
    shape = (batch, seq or XLSTM_GRAPH_SEQ, 4, 384)
    gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    v, k, q = (torch.randn(shape, generator=gen, device=dev)
               for _ in range(3))
    i_g, f_g = (torch.randn(shape[:3], generator=gen, device=dev)
                for _ in range(2))
    x = (v * torch.sigmoid(i_g)[..., None]).to(torch.bfloat16)
    b = (k / math.sqrt(shape[3])).to(torch.bfloat16)
    return x, F.logsigmoid(f_g), b, q.to(torch.bfloat16)


def ssd_wide_times(dev, batch=1, seq=None, chunk=128) -> dict:
    """ssd_scan at the mLSTM's widths on :func:`ssd_wide_inputs`: its
    device time (``ms``), per call (``call_ms``), host work a call
    (``host_ms``) and where the time goes (``trace``, from
    :func:`kernel_trace`).  It times whichever ``repro_torch`` is imported,
    so another checkout's kernel is timed with that checkout's ``src`` on
    ``PYTHONPATH``::

        PYTHONPATH=<checkout>/src python3 -c 'import chip_smoke as s, torch;
            print(s.ssd_wide_times(torch.device("cuda"), 8, 512))'
    """
    from repro_torch.kernels import ssd_scan as ssd_mod
    x, la, b, c = ssd_wide_inputs(dev, batch, seq)

    def call():
        return ssd_mod.ssd_scan(x, la, b, c, chunk=chunk)
    return dict(ms=time_ms(call), call_ms=time_ms(call, hold=False),
                host_ms=host_ms(call), trace=kernel_trace(call))


def ssd_mlstm_row(dev, launches, by_stage=None, batch=1, seq=None,
                  name="ssd_scan_mlstm_hd384", launches_of=None) -> dict:
    """The ssd_scan row at xlstm-125m's mLSTM widths on
    :func:`ssd_wide_inputs`, chunk 128 (the wide route), held against the
    plain version and timed beside it and beside the earlier kernel's
    time; where its time goes: each pass's device time from a trace, their
    sum and the span of a call; ``launches`` are the xLSTM path's
    wide-route ones, ``by_stage`` the same by stage."""
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import ssd_scan as ssd_mod

    chunk = 128
    x, la, b, c = ssd_wide_inputs(dev, batch, seq)
    shape = tuple(x.shape)
    Bn, Sn, Hn, P = shape
    y, fin = ssd_mod.ssd_scan(x, la, b, c, chunk=chunk)
    args = (x.float(), la, b.float(), c.float())
    y_ref, fin_ref = ref.ssd_ref(*args, chunk=chunk)
    err = check_close(f"{name} y vs plain", y, y_ref)
    fin_err = check_close(f"{name} final state vs plain", fin, fin_ref)

    t = ssd_wide_times(dev, batch, seq, chunk)
    ms, call_ms, host, trace = t["ms"], t["call_ms"], t["host_ms"], t["trace"]
    plain_ms = time_ms(lambda: ref.ssd_ref(*args, chunk=chunk), runs=10)
    nc = -(-Sn // chunk)
    tri = chunk * (chunk + 1) // 2
    flops = 2.0 * Bn * Hn * nc * (tri * P + tri * P + 2 * chunk * P * P)
    ws_bytes = ssd_mod.workspace_bytes({"chunk": chunk}, (x.shape, b.shape),
                                       x.dtype)
    passes = {kind: ssd_mod.mma_passes(report("ssd_scan"), P, la.dtype, P)
              for kind, report in (("ptxas", _build.ptxas_report),
                                   ("sass", _build.sass_opcodes))}
    build = mma_build(name, sum(passes["ptxas"].values(), []),
                      sum(passes["sass"].values(), []), "HGMMA")
    tma = min(o["UTMALDG"] for os_ in passes["sass"].values() for o in os_)
    if not tma:
        raise RuntimeError(f"{name}: a wide pass loads no tile by TMA")
    earlier = SSD_WIDE_EARLIER_MS.get(shape)
    print(f"{name} at {shape}: {ms:.4f} ms of device time; earlier kernel "
          + (f"{earlier:.4f} ms" if earlier else "not measured"))
    if trace:
        kt, over = trace["kernel_ms"], trace["sum_ms"] - trace["span_ms"]
        print(f"{name} where the time goes (torch.profiler trace, per "
              f"call): " + ", ".join(f"{k} {v:.4f} ms" for k, v in kt.items())
              + f"; sum {trace['sum_ms']:.4f} ms, first start to last end "
              f"{trace['span_ms']:.4f} ms ("
              + (f"the passes overlap by {over:.4f} ms: ssd_wide_scan starts "
                 "on the SMs ssd_wide_state leaves free and waits for its "
                 "end" if over >= 0 else
                 f"{-over:.4f} ms of gaps between the passes")
              + "); " + (f"the {ms - trace['span_ms']:.4f} ms of the event "
                         "time beyond the span are the events' own edges"
                         if ms >= trace["span_ms"] else
                         f"the profiled call's span is {trace['span_ms'] - ms:.4f}"
                         " ms above the event time (the profiler's own cost)"))
    else:
        print(f"{name} where the time goes: not measured (the profiler saw "
              "no device time)")
    print(f"{name} bf16 passes: " + "; ".join(
        f"{p}: registers {max(e['registers'] for e in es)}, spill stores "
        f"{max(e['spill_stores'] for e in es)}, "
        f"{ssd_mod.mma_opcode(p)} "
        f"{min(o[ssd_mod.mma_opcode(p)] for o in passes['sass'][p])}, "
        f"UTMALDG {min(o['UTMALDG'] for o in passes['sass'][p])}"
        for p, es in sorted(passes["ptxas"].items())))
    return dict(
        name=name, tpu="ssd_scan.py:93",
        design="wgmma bf16 fed by TMA, warp-specialised, 2 passes (the "
               "states walked per 64 x 128 tile, handed on once as bf16 "
               "high and low parts; "
               "the output over 192-wide P tiles, N in slabs of 64)",
        build=dict(**build, utmaldg=tma, workspace_bytes=ws_bytes,
                   **({"trace": trace} if trace else {})),
        shapes=f"x, b, c {shape} bf16 (x = v sigmoid(i), b = k / sqrt(384), "
               f"c = q), log_a fp32, chunk={chunk}; final-state max abs err "
               f"{fin_err:.4g}; workspace {ws_bytes} B; earlier kernel "
               + (f"{earlier:.4f} ms" if earlier else "not measured"),
        err=err, tol=f"tol {TOL} abs + {TOL} rel", ms=ms, call_ms=call_ms,
        host_ms=host, plain_ms=plain_ms, flops=flops,
        nbytes=moved_bytes(x, la, b, c, y, fin), lib_ms=None,
        launches=launches, **({"launches_split": by_stage} if by_stage else {}),
        **({"launches_of": launches_of} if launches_of else {}))


def flash_noncausal_row(dev, launches) -> dict:
    """flash_attention without a mask at whisper-medium's encoder: q = k =
    v shapes (8, 1500, 16, 64) bf16, against its plain version, timed
    beside it and non-causal ``scaled_dot_product_attention``;
    ``launches`` are the whisper path's non-causal ones."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import flash_attention as fa_mod
    from repro_torch.models import get_config

    c = get_config("whisper-medium")
    shape = (WHISPER["batch"], c.encoder_len, c.n_heads, c.head_dim)
    gen = torch.Generator(device=dev).manual_seed(SEED + 14)
    q, k, v = (torch.randn(shape, generator=gen, device=dev)
               .to(torch.bfloat16) for _ in range(3))
    got = fa_mod.flash_attention(q, k, v, causal=False)
    qf, kf, vf = q.float(), k.float(), v.float()
    err = check_close("flash_attention_noncausal_whisper vs plain", got,
                      ref.flash_attention_ref(qf, kf, vf, causal=False))

    def call():
        return fa_mod.flash_attention(q, k, v, causal=False)
    ms, call_ms = time_ms(call), time_ms(call, hold=False)
    host = host_ms(call)
    plain_ms = time_ms(lambda: ref.flash_attention_ref(qf, kf, vf,
                                                       causal=False), runs=10)
    del qf, kf, vf
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    lib = F.scaled_dot_product_attention(qt, kt, vt)
    check_close("flash_attention_noncausal_whisper: SDPA vs the kernel",
                lib.transpose(1, 2), got)
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt))
    B_, S_, H_, hd = shape
    sass = fa_mod.mma_instances(_build.sass_opcodes("flash_attention"))
    ptxas = fa_mod.mma_instances(_build.ptxas_report("flash_attention"))
    build = mma_build("flash_attention_noncausal_whisper", ptxas[hd],
                      sass[hd])
    return dict(
        name="flash_attention_noncausal_whisper", tpu="flash_attention.py:122",
        design="mma.sync bf16, no mask", build=build,
        shapes=f"q, k, v {shape} bf16, causal=False (whisper-medium's "
               "encoder); library: scaled_dot_product_attention, no mask",
        err=err, tol=f"tol {TOL} abs + {TOL} rel", ms=ms, call_ms=call_ms,
        host_ms=host, plain_ms=plain_ms, flops=4.0 * B_ * H_ * hd * S_ * S_,
        nbytes=moved_bytes(q, k, v, got), lib_ms=lib_ms, launches=launches)


def decode_row(name, design, dev, B, Smax, H, Hk, hd, lengths, window,
               launches, launches_of=None):
    """A decode_attention row at the given widths: the kernel, at the
    block_k its wrapper chooses as on the path, held against its plain
    version (``check_decode``) and timed beside it and
    ``scaled_dot_product_attention`` with the same mask.  ``launches`` is
    the count of the path that runs these widths, or, with
    ``launches_of``, of the path named there."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import _build
    from repro_torch.kernels import decode_attention as da_mod
    from repro_torch.kernels import ref

    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    q = torch.randn((B, H, hd), generator=gen, device=dev,
                    dtype=torch.bfloat16)
    k, v = (torch.randn((B, Smax, Hk, hd), generator=gen, device=dev,
                        dtype=torch.bfloat16) for _ in range(2))
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    qf, kf, vf = q.float(), k.float(), v.float()
    want = ref.decode_attention_ref(qf, kf, vf, lens, window=window)

    def call():
        return da_mod.decode_attention(q, k, v, lens, window=window)
    got = call()
    err, rel = check_decode(f"{name} vs plain", got, want, want)
    ms, call_ms = time_ms(call), time_ms(call, hold=False)
    host = host_ms(call)
    plain_ms = time_ms(lambda: ref.decode_attention_ref(
        qf, kf, vf, lens, window=window), runs=10)
    del kf, vf
    kpos = torch.arange(Smax, device=dev)
    mask = kpos[None, :] < lens[:, None]
    if window:
        mask &= kpos[None, :] >= lens[:, None] - window
    qv = q.view(B, H, 1, hd)
    kt, vt = (t.transpose(1, 2).contiguous() for t in (k, v))
    mask4 = mask[:, None, None, :]
    if H != Hk:
        kt, vt = (t.repeat_interleave(H // Hk, dim=1) for t in (kt, vt))

    def lib():
        return F.scaled_dot_product_attention(qv, kt, vt, attn_mask=mask4)
    check_decode(f"{name}: scaled_dot_product_attention vs plain",
                 lib().view(q.shape), want, want)
    lib_ms = time_ms(lib)
    plan = da_mod.split_plan(q, k, window=window)
    rows = int(mask.sum())                   # cache rows the call needs
    # the bf16 instance at this head_dim: registers, spills and HMMA
    build = mma_build(name, [da_mod.mma_instances(
        _build.ptxas_report("decode_attention"))[hd]], [da_mod.mma_instances(
            _build.sass_opcodes("decode_attention"))[hd]])
    return dict(
        name=name, tpu="decode_attention.py:100", design=design,
        build=dict(**build, nsplit=plan["nsplit"],
                   ctas_per_sm=plan["ctas_per_sm"],
                   smem_bytes=plan["smem_bytes"]),
        shapes=f"q {tuple(q.shape)} bf16, k, v {tuple(k.shape)} bf16, "
               f"lengths {lengths}, window {window}, "
               f"block_k={plan['block_k']}; "
               f"relative norm err {rel:.4g}; library: "
               "scaled_dot_product_attention with the mask"
               + (", kv heads repeated" if H != Hk else ""),
        err=err, tol=f"tol {DEC_ATOL} x RMS abs + {DEC_RTOL} rel, norm "
                     f"{DEC_NORM}",
        ms=ms, call_ms=call_ms, host_ms=host, plain_ms=plain_ms,
        flops=4.0 * H * hd * rows,
        nbytes=moved_bytes(q, got, lens) + 2.0 * rows * Hk * hd * 2,
        lib_ms=lib_ms, launches=launches,
        **({"launches_of": launches_of} if launches_of else {}))


def lm_phase(dev, resources, net, out_dir, prefill_db) -> list:
    """The LM models and the serving engine at full size: granite-8b
    (Scission loop over lm_to_graph, then the bucketed engine), zamba2-2.7b
    and zamba2-7b (the exact engine), the example's reduced gemma2, qwen2-moe-a2.7b (DAG
    loop over its layer 0 MoE, the bucketed engine), xlstm-125m (DAG loop,
    the exact engine), whisper-medium (prefill and decode over frames, DAG
    loop) and internvl2-76b's backbone cut in depth; then a
    decode_attention row at each engine's widths and the lengths of its
    heaviest decode step (the example's with its window), one at
    gemma2-9b's full widths with its window, which no path runs, and the
    rows of the new routes: ssd_scan at the mLSTM's 384-wide heads, flash
    without a mask and decode over whisper's cross cache; then decode rows
    at the other families' widths and the lengths of their heaviest step
    (whisper's self-attention, the qwen2-moe engine, internvl2), the SSD
    decode at the zamba2-2.7b and xlstm-125m engines' widths, and
    zamba2-7b's four rows
    (:func:`zamba2_7b_rows`).  The rows
    run under the adopted sizes, as the paths did.  Returns those rows."""
    import time

    import torch
    from repro_torch.kernels import substrate
    from repro_torch.models import get_config
    from repro_torch.models.xlstm import mlstm_dims

    t0 = time.perf_counter()
    gc.collect()
    adopted = substrate.adopt_tuned_params(prefill_db, dtype="bfloat16")
    print(f"lm adopted tuned params from the prefill DB: {adopted}")
    granite = lm_granite(dev, resources, net, out_dir)
    print(f"lm granite-8b: {time.perf_counter() - t0:.1f} s of wall time")
    t1 = time.perf_counter()
    zamba = lm_zamba(dev)
    print(f"lm zamba2-2.7b: {time.perf_counter() - t1:.1f} s of wall time")
    t1 = time.perf_counter()
    zamba7 = lm_zamba2_7b(dev)
    print(f"lm zamba2-7b: {time.perf_counter() - t1:.1f} s of wall time; "
          f"launches {zamba7['launches']}")
    t1 = time.perf_counter()
    example = lm_example(dev)
    print(f"lm example: {time.perf_counter() - t1:.1f} s of wall time; "
          f"launches {example['launches']}")
    torch.cuda.empty_cache()
    others = {}
    for name, fn in (("qwen2-moe-a2.7b",
                      lambda: lm_qwen_moe(dev, resources, net)),
                     ("xlstm-125m", lambda: lm_xlstm(dev, resources, net)),
                     ("whisper-medium",
                      lambda: lm_whisper(dev, resources, net)),
                     ("internvl2-76b", lambda: lm_internvl(dev))):
        t1 = time.perf_counter()
        others[name] = fn()
        # the last model's weights may hang on reference cycles (a graph's
        # closures): free them before the next model's peak is read
        gc.collect()
        torch.cuda.empty_cache()
        print(f"lm {name}: {time.perf_counter() - t1:.1f} s of wall time; "
              f"launches {others[name]['launches']}")

    t1 = time.perf_counter()
    mma = "mma.sync bf16, split-KV, one wave"
    gr, zc, ec = get_config("granite-8b"), get_config("zamba2-2.7b"), \
        example["cfg"]
    g9, wc = get_config("gemma2-9b"), get_config("whisper-medium")
    qc, ic = get_config("qwen2-moe-a2.7b"), get_config("internvl2-76b")
    xc = get_config("xlstm-125m")
    qwen, whisper, internvl = (others[n] for n in (
        "qwen2-moe-a2.7b", "whisper-medium", "internvl2-76b"))
    xl = others["xlstm-125m"]["launches"]
    wide = {stage: xl[f"ssd_scan wide route ({stage})"]
            for stage in ("DAG loop", "engine")}
    ge = GRANITE_ENGINE
    rows = [
        decode_row("decode_attention_granite_engine", mma, dev, ge["width"],
                   ge["max_len"], gr.n_heads, gr.n_kv_heads, gr.head_dim,
                   granite["lengths"], None,
                   granite["launches"]["decode_attention"]),
        decode_row("decode_attention_hd80", f"{mma}; head_dim 80 instance",
                   dev, ZAMBA_ENGINE["width"], ZAMBA_ENGINE["max_len"],
                   zc.n_heads, zc.n_kv_heads, zc.head_dim, zamba["lengths"],
                   None, zamba["launches"]["decode_attention"]),
        # the example's local layers: its global layers' calls are in the
        # count too
        decode_row("decode_attention_window", f"{mma}; sliding window",
                   dev, example["width"], example["max_len"], ec.n_heads,
                   ec.n_kv_heads, ec.head_dim, example["lengths"], ec.window,
                   example["launches"]["decode_attention"]),
        # gemma2-9b's local layers: a window of 4096 over an 8192-entry
        # cache at head_dim 256; no path runs these widths
        decode_row("decode_attention_window_gemma2_9b",
                   f"{mma}; sliding window", dev, 4, 2 * g9.window,
                   g9.n_heads, g9.n_kv_heads, g9.head_dim,
                   [2 * g9.window, g9.window + 1000, g9.window, 1000],
                   g9.window, example["launches"]["decode_attention"],
                   launches_of="the reduced gemma2 example (head_dim 32, "
                               "window 16), not these widths"),
        ssd_mlstm_row(dev, sum(wide.values()), wide),
        ssd_decode_row(dev, "ssd_decode_zamba2_2p7b", ZAMBA_ENGINE["width"],
                       zc.ssm_expand * zc.d_model // zc.ssm_head_dim,
                       zc.ssm_groups, zc.ssm_state, zc.ssm_head_dim,
                       zamba["launches"]["ssd_decode"]),
        ssd_decode_row(dev, "ssd_decode_mlstm_hd384", XLSTM_ENGINE["width"],
                       xc.n_heads, xc.n_heads, mlstm_dims(xc)[2],
                       mlstm_dims(xc)[2], xl["ssd_decode (engine)"]),
        flash_noncausal_row(dev, others["whisper-medium"]["launches"]
                            ["flash non-causal"]),
        decode_row("decode_attention_cross_whisper",
                   f"{mma}; the cross cache", dev, WHISPER["batch"],
                   wc.encoder_len, wc.n_heads, wc.n_kv_heads, wc.head_dim,
                   [wc.encoder_len] * WHISPER["batch"], None,
                   whisper["launches"]["decode cross"]),
        decode_row("decode_attention_self_whisper",
                   f"{mma}; the decoder's self-attention", dev,
                   WHISPER["batch"], WHISPER["max_len"], wc.n_heads,
                   wc.n_kv_heads, wc.head_dim, whisper["lengths"], None,
                   whisper["launches"]["decode self"]),
        decode_row("decode_attention_qwen2_moe_engine", mma, dev,
                   QWEN_ENGINE["width"], QWEN_ENGINE["max_len"], qc.n_heads,
                   qc.n_kv_heads, qc.head_dim, qwen["lengths"], None,
                   qwen["launches"]["decode_attention"]),
        decode_row("decode_attention_internvl2", f"{mma}; 8 query heads a "
                   "kv head", dev, INTERNVL["batch"], internvl["max_len"],
                   ic.n_heads, ic.n_kv_heads, ic.head_dim,
                   internvl["lengths"], None,
                   internvl["launches"]["decode_attention"]),
    ]
    rows += zamba2_7b_rows(dev, zamba7)
    substrate.clear_tuned_params()
    print(f"lm decode rows: {time.perf_counter() - t1:.1f} s of wall time")
    print(f"lm phase: {time.perf_counter() - t0:.1f} s of wall time")
    return rows


# training (slice E): xlstm-125m as examples/train_small_lm_torch.py trains
# it, at the reference's batch of 8 and 512 tokens (four mLSTM chunks of
# 128), checkpointed every 20 steps and resumed from the step-20
# checkpoint; zamba2-2.7b as registered (remat, the loss in chunks of 1024)
# at 2 x 2048 tokens
TRAIN_XLSTM = dict(steps=40, batch=8, seq=512, ckpt_every=20, peak_lr=3e-3,
                   warmup=20, weight_decay=0.01)
TRAIN_ZAMBA = dict(steps=3, batch=2, seq=2048)
# the other families, widths as published, depth cut where a card cannot
# hold the AdamW state (12 B a parameter) beside the weights and the rest:
# qwen2-moe-a2.7b 4 of 24 layers (2.732e9 parameters, 32.8 GB of state;
# 178 GB at full depth), whisper-medium whole (0.758e9) at its 1500 frames
# and 448-token decoder context, internvl2-76b's backbone 2 of 80 layers
# (2.762e9; 4 layers would need 53.7 GB of state) over 256 patch embeddings
# and 1024 text tokens
TRAIN_MOE = dict(steps=3, batch=2, seq=2048, layers=4)
TRAIN_WHISPER = dict(steps=3, batch=4, seq=448)
TRAIN_INTERNVL = dict(steps=3, batch=2, seq=1024, layers=2)
# the resumed run's losses against the uninterrupted run's, relative:
# decided before the first run on the card; the restored state is already
# held bit for bit, so a few resumed steps show the run goes on as before
RESUME_TOL = 1e-2
RESUME_STEPS = 5
# an autograd Function's gradients against plain autograd's through the
# plain version on the same inputs (relative L2 per input): its backward is
# that computation, so anything but rounding is a fault of the wiring
FN_GRAD_TOL = 1e-3
# zamba2-2.7b's gradient tree with the kernels against the plain versions'
# (relative L2), and each leaf that only the kernels' gradients reach: set
# near the geometric middle between the sound run's reading (tree 0.0945,
# worst such leaf 0.157 on an H100) and that of the fault the autograd
# Functions repair (the kernels' gradients cut: tree 0.992, each such leaf
# 1), both read every run; the plain versions in bf16 lie 0.23 from the
# same in fp32, so the sound reading is bf16's own rounding
TRAIN_GRAD_TOL = 0.3
TRAIN_LEAF_TOL = 0.4
# a leaf whose gradient is zero in exact arithmetic (an attention's k bias,
# which the softmax does not see: whisper-medium's and qwen2-moe-a2.7b's)
# holds rounding noise in every run; its distance is taken relative to at
# least this fraction of the whole tree's norm, as
# tests/test_torch_train_loss.py's ZERO_FLOOR takes it
LEAF_FLOOR = 1e-4


def train_steps(model, step_fn, params, opt, data, start, stop, sup=None,
                on_step=None, prepare=None) -> tuple:
    """Steps ``[start, stop)`` of ``step_fn`` on the pipeline's batches;
    each step, the loss and AdamW timed apart with CUDA events (the
    backward is the rest of the step).  ``sup`` checkpoints as the trainer
    does (the state after step + 1 steps, labelled so); ``on_step(step,
    state)`` runs after each; ``prepare(batch)`` lays a batch out for the
    step (a mesh's DTensors).  Returns (params, opt, numbers)."""
    import time

    import torch
    from repro_torch.launch import steps as steps_mod
    from repro_torch.launch.train import device_batch

    total, fwd, upd = StepClock(), StepClock(), StepClock()
    real_apply = steps_mod.apply_updates
    model.loss = fwd.wrap(model.loss)
    steps_mod.apply_updates = upd.wrap(real_apply)
    timed = total.wrap(step_fn)
    losses, aux = [], []
    torch.cuda.reset_peak_memory_stats()
    try:
        for step in range(start, stop):
            batch = device_batch(model.cfg, data.global_batch_at(step),
                                 model.device)
            if prepare is not None:
                batch = prepare(batch)
            t0 = time.perf_counter()
            params, opt, metrics = timed(params, opt, batch)
            losses.append(metrics["loss"])
            aux.append(metrics["aux"])
            if sup is not None:
                sup.after_step(step + 1, {"p": params, "o": opt},
                               time.perf_counter() - t0)
            if on_step is not None:
                on_step(step, {"p": params, "o": opt})
        if sup is not None:
            sup.ckpt.wait()
    finally:
        del model.loss
        steps_mod.apply_updates = real_apply
    step_ms, fwd_ms, opt_ms = total.ms(), fwd.ms(), upd.ms()
    return params, opt, dict(
        losses=[float(v) for v in losses], aux=[float(v) for v in aux],
        step_ms=statistics.median(step_ms), fwd_ms=statistics.median(fwd_ms),
        opt_ms=statistics.median(opt_ms),
        bwd_ms=statistics.median(t - f - o for t, f, o in
                                 zip(step_ms, fwd_ms, opt_ms)),
        peak_gb=torch.cuda.max_memory_allocated() / 1e9)


def report_training(card, label, cfg, run, batch, seq, peak_flops,
                    launches) -> None:
    """Prints a training run's numbers, each beside the card."""
    from repro_torch.launch.steps import count_params
    n = count_params(cfg)
    tokens = batch * seq
    rate = 6.0 * n * tokens / (run["step_ms"] / 1e3)
    print(f"[{card}] train {label}: {n / 1e9:.4f}e9 parameters; batch "
          f"{batch} x {seq} tokens; step {run['step_ms']:.1f} ms (forward + "
          f"loss {run['fwd_ms']:.1f}, backward {run['bwd_ms']:.1f}, AdamW "
          f"{run['opt_ms']:.1f}; CUDA-event medians over "
          f"{len(run['losses'])} steps); {tokens / run['step_ms'] * 1e3:.0f} "
          f"tokens/s; 6 N tokens / step = {rate / 1e12:.2f} TFLOP/s, "
          f"{rate / peak_flops:.2%} of {peak_flops / 1e12:.0f}; peak memory "
          f"{run['peak_gb']:.2f} GB; launches {launches}")


def train_xlstm(dev, card, peak_flops, ckpt_dir) -> dict:
    """xlstm-125m trained at full size for ``TRAIN_XLSTM["steps"]`` steps
    and resumed from its step-20 checkpoint for ``RESUME_STEPS`` steps;
    raises unless the loss falls, the wide ssd_scan route and its plain
    backward run, the restored state equals the saved one bit for bit and
    the resumed losses agree within ``RESUME_TOL``."""
    import torch
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import build_model, get_config
    from repro_torch.models import layers as L
    from repro_torch.optim import AdamWConfig, cosine_with_warmup, init_state
    from repro_torch.runtime.ft import TrainSupervisor

    t = TRAIN_XLSTM
    label = "xlstm-125m"
    cfg = get_config("xlstm-125m").replace(remat=False, loss_seq_chunk=None)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=t["seq"],
                                  global_batch=t["batch"], seed=SEED))
    adamw = AdamWConfig(lr=cosine_with_warmup(t["peak_lr"], t["warmup"],
                                              t["steps"]),
                        weight_decay=t["weight_decay"])

    def fresh():
        model = build_model(cfg, device=dev)
        params = model.init(seed=SEED, dtype=torch.bfloat16)
        return model, params, init_state(params)

    model, params, opt = fresh()
    sup = TrainSupervisor(CheckpointManager(ckpt_dir, keep=2),
                          ckpt_every=t["ckpt_every"])
    saved = {}

    def keep(step, state):
        if step + 1 == t["ckpt_every"]:
            saved.update(L.tree_map(lambda a: a.clone(), state))

    start = kernel_launches()
    params, opt, run = train_steps(model, make_train_step(model, adamw),
                                   params, opt, data, 0, t["steps"], sup,
                                   keep)
    launches = kernel_launches(start)
    report_training(card, label, cfg, run, t["batch"], t["seq"], peak_flops,
                    launches)
    losses = run["losses"]
    first, last = (statistics.mean(losses[:5]),
                   statistics.mean(losses[-5:]))
    print(f"[{card}] train {label}: loss {first:.4f} (first 5 steps) -> "
          f"{last:.4f} (last 5); checkpoints {sup.ckpt.steps()}")
    if not last < first:
        raise RuntimeError(f"train {label}: the loss did not fall "
                           f"({first:.4f} -> {last:.4f})")
    if launches["ssd_scan wide route"] <= 0 or \
            launches["ssd_scan backward (plain)"] <= 0:
        raise RuntimeError(f"train {label}: the wide ssd_scan route or its "
                           f"plain backward did not run: {launches}")
    del model, params, opt

    # a fresh model resumes from the step-20 checkpoint, alone in a
    # directory of its own (the run also saved its last step)
    resume_dir = os.path.join(ckpt_dir, "resume")
    os.makedirs(resume_dir)
    name = os.path.basename(sup.ckpt._path(t["ckpt_every"]))
    os.replace(os.path.join(ckpt_dir, name), os.path.join(resume_dir, name))
    model, params, opt = fresh()
    state, start = TrainSupervisor(
        CheckpointManager(resume_dir, keep=2),
        ckpt_every=t["ckpt_every"]).resume_or_init(
            lambda: {"p": params, "o": opt}, like={"p": params, "o": opt})
    if start != t["ckpt_every"]:
        raise RuntimeError(f"train {label}: resumed at step {start}, not "
                           f"{t['ckpt_every']}")
    same = all(torch.equal(a, b) and a.dtype == b.dtype for a, b in
               zip(L.tree_leaves(state), L.tree_leaves(saved)))
    if not same or len(L.tree_leaves(state)) != len(L.tree_leaves(saved)):
        raise RuntimeError(f"train {label}: the restored state differs "
                           "from the one saved at step 20")
    del saved
    stop = start + RESUME_STEPS
    _, _, resumed = train_steps(model, make_train_step(model, adamw),
                                state["p"], state["o"], data, start, stop)
    diffs = [abs(a - b) / abs(b) for a, b in zip(resumed["losses"],
                                                 losses[start:stop])]
    print(f"[{card}] train {label}: resumed at step {start} from "
          f"{ckpt_dir}, parameters and moments equal to the saved ones bit "
          f"for bit; steps {start}-{stop - 1}: largest relative loss "
          f"difference {max(diffs):.3g} (bound {RESUME_TOL}); resumed step "
          f"{resumed['step_ms']:.1f} ms")
    if not max(diffs) <= RESUME_TOL:
        raise RuntimeError(f"train {label}: resumed losses differ by "
                           f"{max(diffs):.3g} (bound {RESUME_TOL})")
    return dict(launches=launches, run=run, first=first, last=last,
                resume_diff=max(diffs))


def _cut_gradients():
    """The kernels launched outside their autograd Function, as a context
    manager: the outputs carry no ``grad_fn``, so every gradient stops at
    the kernels (the fault the Function repairs) while the loss stays as
    it was."""
    import contextlib

    from repro_torch.kernels.substrate import KernelFunction

    @contextlib.contextmanager
    def patched():
        KernelFunction.apply = staticmethod(
            lambda name, launch, plain, *inputs: launch(*inputs))
        try:
            yield
        finally:
            del KernelFunction.apply

    return patched()


def grad_gap(got, want) -> tuple[float, dict]:
    """Relative L2 of the gradient tree ``got`` against ``want``, and each
    leaf's own by path (a zero ``want`` leaf is left out), relative to at
    least ``LEAF_FLOOR`` of the whole tree's norm."""
    from repro_torch.models import layers as L
    parts = []
    for (path, g), w in zip(_paths(got), L.tree_leaves(want)):
        parts.append((path, (g.float() - w.float()).square().sum().item(),
                      w.float().square().sum().item()))
    num, den = sum(p[1] for p in parts), sum(p[2] for p in parts)
    floor = LEAF_FLOOR ** 2 * den
    leaves = {path: (e / max(n, floor)) ** 0.5 for path, e, n in parts
              if n > 0}
    return (num / den) ** 0.5, leaves


def train_family(dev, card, peak_flops, label, t, kernels, cfg=None,
                 routes=None) -> dict:
    """``label``'s model at published widths (``cfg`` cuts its depth).
    One loss and gradient on step 0's batch four ways: with the kernels,
    with their plain versions in both directions, with the kernels'
    gradients cut (the fault the autograd Functions repair) and with the
    plain versions in fp32 on the same weights (bf16's own noise); an MoE
    routes the last three as the kernel run routed (``_routes``), so that
    no top-k choice flips whole expert leaves between them.  Raises unless
    the kernel run's loss lies within ``LM_TOL`` of the plain run's, its
    gradient tree within ``TRAIN_GRAD_TOL`` and each leaf that only the
    kernels' gradients reach within ``TRAIN_LEAF_TOL``, while the cut
    run's tree lies outside ``TRAIN_GRAD_TOL``.  Then ``t["steps"]`` train
    steps that must launch each of ``kernels`` and run its plain backward,
    with finite losses (and an MoE's aux finite and above 0).  ``routes``
    (module, name, key_of) triples count the steps' flash launches by
    route (``_route_counter``).  Returns the launches, the routes' counts
    and the numbers."""
    import contextlib

    import torch
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.launch.steps import make_train_step, value_and_grad
    from repro_torch.launch.train import device_batch
    from repro_torch.models import layers as L
    from repro_torch.optim import AdamWConfig, init_state

    model, params = lm_model(label, dev, cfg)
    c = model.cfg
    data = SyntheticLM(DataConfig(
        vocab=c.vocab, seq_len=t["seq"], global_batch=t["batch"], seed=SEED,
        encoder_len=c.encoder_len if c.is_encdec else 0,
        n_img_tokens=c.n_img_tokens, d_model=c.d_model))
    batch = device_batch(c, data.global_batch_at(0), dev)
    log = {"routes": []}

    def routed(first=False):
        if not c.moe_experts:
            return contextlib.nullcontext()
        return _routes(log) if first else _routes({"routes": []},
                                                    forced=log)

    with routed(first=True):
        loss_k, _, grads_k = value_and_grad(model.loss, params, batch)
    with _plain_kernels(), routed():
        loss_p, _, grads_p = value_and_grad(model.loss, params, batch)
    with _cut_gradients(), routed():
        _, _, grads_c = value_and_grad(model.loss, params, batch)
    # the leaves only the kernels' gradients reach: zero when they are cut
    fed = [path for (path, g), p in zip(_paths(grads_c),
                                        L.tree_leaves(grads_p))
           if not g.any() and p.any()]
    sound, sound_leaf = grad_gap(grads_k, grads_p)
    fault, fault_leaf = grad_gap(grads_c, grads_p)
    del grads_c
    wide = L.tree_map(lambda a: a.float(), params)
    with _plain_kernels(), routed():
        _, _, grads_f = value_and_grad(model.loss, wide, batch)
    del wide
    noise, noise_leaf = grad_gap(grads_p, grads_f)
    kernel_f, _ = grad_gap(grads_k, grads_f)
    del grads_k, grads_p, grads_f
    gc.collect()
    torch.cuda.empty_cache()
    loss_rel = abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())
    worst = max(sound_leaf, key=sound_leaf.get)
    forced = (f"; the plain, cut and fp32 runs routed as the kernel run's "
              f"{sum(r.numel() for r in log['routes'])} top-{c.moe_top_k} "
              f"choices" if c.moe_experts else "")
    print(f"[{card}] train {label} vs the plain versions (no kernel in "
          f"either direction), step 0's batch: loss {loss_k.item():.5f} vs "
          f"{loss_p.item():.5f}, relative {loss_rel:.3g} (bound {LM_TOL}); "
          f"gradient tree relative L2: kernels {sound:.4g} (bound "
          f"{TRAIN_GRAD_TOL}), the kernels' gradients cut {fault:.4g} (must "
          f"exceed {TRAIN_GRAD_TOL}); against the plain versions in fp32: "
          f"plain bf16 {noise:.4g}, kernels {kernel_f:.4g} (not checked); "
          f"worst leaf {worst} {sound_leaf[worst]:.4g} (plain bf16 vs fp32 "
          f"{noise_leaf.get(worst, 0.0):.4g}){forced}")
    print(f"[{card}] train {label}: {len(fed)} leaves only the kernels' "
          f"gradients reach (bound {TRAIN_LEAF_TOL} each), kernels / cut / "
          f"plain bf16 vs fp32: " + ", ".join(
              f"{path} {sound_leaf[path]:.4g} / {fault_leaf[path]:.4g} / "
              f"{noise_leaf.get(path, 0.0):.4g}" for path in fed))
    if not loss_rel <= LM_TOL:
        raise RuntimeError(f"train {label}: loss differs from the plain "
                           f"run by {loss_rel:.3g}")
    if not sound <= TRAIN_GRAD_TOL:
        raise RuntimeError(f"train {label}: gradients differ from the plain "
                           f"run by {sound:.4g} (bound {TRAIN_GRAD_TOL})")
    if not fault > TRAIN_GRAD_TOL:
        raise RuntimeError(f"train {label}: with the kernels' gradients cut "
                           f"the tree reads {fault:.4g}, inside the bound "
                           f"{TRAIN_GRAD_TOL}: the check cannot see the "
                           "fault")
    if not fed:
        raise RuntimeError(f"train {label}: no leaf's gradient vanished with "
                           "the kernels' gradients cut")
    over = {p: sound_leaf[p] for p in fed if not sound_leaf[p] <=
            TRAIN_LEAF_TOL}
    if over:
        raise RuntimeError(f"train {label}: leaves the kernels' gradients "
                           f"reach differ from the plain run by more than "
                           f"{TRAIN_LEAF_TOL}: {over}")

    opt = init_state(params)
    counts = Counter()
    saved = [(module, name, _route_counter(module, name, counts, key_of))
             for module, name, key_of in routes or ()]
    start = kernel_launches()
    try:
        params, opt, run = train_steps(
            model, make_train_step(model, AdamWConfig()), params, opt, data,
            0, t["steps"])
    finally:
        for module, name, real in saved:
            setattr(module, name, real)
    launches = kernel_launches(start)
    report_training(card, label, c, run, t["batch"], t["seq"], peak_flops,
                    launches)
    print(f"[{card}] train {label}: losses "
          + ", ".join(f"{v:.5f}" for v in run["losses"])
          + (f"; aux " + ", ".join(f"{v:.5f}" for v in run["aux"])
             if c.moe_experts else "")
          + (f"; flash launches by route {dict(counts)}" if routes else ""))
    for k in kernels:
        for key in (k, f"{k} backward (plain)"):
            if launches[key] <= 0:
                raise RuntimeError(f"train {label}: no {key} launch in the "
                                   "steps")
    if not all(math.isfinite(v) for v in run["losses"]):
        raise RuntimeError(f"train {label}: a loss is not finite")
    if c.moe_experts and not all(math.isfinite(v) and v > 0
                                 for v in run["aux"]):
        raise RuntimeError(f"train {label}: the router's aux loss is not "
                           f"finite and above 0: {run['aux']}")
    del model, params, opt
    return dict(launches=launches, routes=dict(counts), run=run,
                loss_rel=loss_rel, grad_rel=sound, grad_cut=fault,
                grad_noise=noise)


def _paths(tree, prefix=""):
    """(path, leaf) in ``layers.tree_leaves`` order."""
    if isinstance(tree, dict):
        return [pl for k in sorted(tree)
                for pl in _paths(tree[k], f"{prefix}/{k}")]
    return [(prefix, tree)]


def train_kernel_checks(dev) -> dict:
    """Each autograd Function at the train path's shapes, its launches
    counted from 0: the kernel's forward held against the plain version
    (``TOL``, as the kernel rows), the Function's gradients against plain
    autograd's through the plain version on the same inputs
    (``FN_GRAD_TOL``, relative L2 per input), and one backward timed (the
    plain version recomputed from the saved inputs and differentiated, the
    graph kept between calls).  Raises on a disagreement or a count that
    is not one launch each way."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa_mod
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_scan as ssd_mod
    from repro_torch.models import get_config

    gen = torch.Generator(device=dev).manual_seed(SEED + 21)

    def randn(*shape, dtype=torch.bfloat16, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(
            dtype).requires_grad_()

    def grad_gaps(name, outs, plain_outs, inputs, names, seeds):
        """The Function's gradients and plain autograd's, relative L2."""
        got = torch.autograd.grad(outs, inputs, seeds, retain_graph=True)
        want = torch.autograd.grad(plain_outs, inputs, seeds)
        gaps = {}
        for n, g, w in zip(names, got, want):
            gaps[n] = rel_err(g, w)
            if not gaps[n] <= FN_GRAD_TOL or not w.abs().sum() > 0:
                raise RuntimeError(f"{name}: the Function's d{n} differs from "
                                   f"plain autograd's by {gaps[n]:.3g} "
                                   f"(bound {FN_GRAD_TOL})")
        return gaps

    def counted(name, start, *keys):
        seen = kernel_launches(start, keys)
        if any(v != 1 for v in seen.values()):
            raise RuntimeError(f"{name}: launches {seen}, not one each way")
        return seen

    zc, xc = TRAIN_ZAMBA, TRAIN_XLSTM
    out = {}

    def flash_case(name, q_shape, kv_shape, causal, note):
        start = kernel_launches()
        q, k, v = randn(*q_shape), randn(*kv_shape), randn(*kv_shape)
        o = fa_mod.flash_attention(q, k, v, causal=causal)
        o_ref = ref.flash_attention_ref(q, k, v, causal=causal)
        err = check_close(f"{name} (train path) vs plain", o, o_ref)
        go = randn(*o.shape).detach()
        gaps = grad_gaps(name, o, o_ref, (q, k, v), "qkv", go)
        del o_ref
        out[name] = dict(
            shapes=f"q {tuple(q.shape)}, k, v {tuple(k.shape)} bf16 "
                   f"{'causal' if causal else 'non-causal'} ({note})",
            err=err, gaps=gaps,
            launches=counted(name, start, "flash_attention",
                             "flash_attention backward (plain)"),
            ms=time_ms(lambda: torch.autograd.grad(o, (q, k, v), go,
                                                   retain_graph=True),
                       runs=5))

    shape = (zc["batch"], zc["seq"], 32, 80)
    flash_case("flash_attention", shape, shape, True,
               "zamba2-2.7b's shared attention")
    # whisper-medium's cross-attention: the decoder's 448 queries over the
    # encoder's 1500 frames, no mask
    wc, w = get_config("whisper-medium"), TRAIN_WHISPER
    flash_case("flash_attention_cross_whisper",
               (w["batch"], w["seq"], wc.n_heads, wc.head_dim),
               (w["batch"], wc.encoder_len, wc.n_heads, wc.head_dim), False,
               "whisper-medium's cross-attention")

    def ssd_case(name, x, la, b, c, shared, note, *wide):
        start = kernel_launches()
        B_, S_, H_, _ = x.shape
        N_ = b.shape[-1]
        inputs = (x, la, b, c)
        views = [t.expand(B_, S_, H_, N_) for t in (b, c)]
        y, fin = ssd_mod.ssd_scan(x, la, *views, chunk=128)
        y_ref, fin_ref = ref.ssd_ref(x, la, *views, chunk=128)
        err = check_close(f"{name} (train path) y vs plain", y, y_ref)
        fin_err = check_close(f"{name} (train path) final state vs plain",
                              fin, fin_ref)
        seeds = (randn(*y.shape).detach(), randn(*fin.shape).detach())
        gaps = grad_gaps(name, (y, fin), (y_ref, fin_ref), inputs,
                         ("x", "log_a", "b", "c"), seeds)
        del y_ref, fin_ref
        out[name] = dict(
            shapes=f"x {tuple(x.shape)} bf16, b, c ({B_}, {S_}, "
                   f"{1 if shared else H_}, {N_}) bf16"
                   f"{' expanded over the heads' if shared else ''}, log_a "
                   f"fp32, chunk 128 ({note}); final-state max abs err "
                   f"{fin_err:.4g}", err=err, gaps=gaps,
            launches=counted(name, start, "ssd_scan",
                             "ssd_scan backward (plain)", *wide),
            ms=time_ms(lambda: torch.autograd.grad(
                (y, fin), inputs, seeds, retain_graph=True), runs=5))

    # zamba2-2.7b's Mamba-2: b, c shared over the 80 heads, c scaled so
    # that c . b is of unit size
    B_, S_, H_, N_ = zc["batch"], zc["seq"], 80, 64
    ssd_case("ssd_scan", randn(B_, S_, H_, 64),
             (-torch.rand(B_, S_, H_, generator=gen, device=dev) * 0.1)
             .requires_grad_(), randn(B_, S_, 1, N_),
             randn(B_, S_, 1, N_, scale=N_ ** -0.5), True,
             "zamba2-2.7b's Mamba-2")
    # xlstm-125m's mLSTM: b = k / sqrt(384), c = q, log_a = log sigmoid(f)
    B_, S_, H_, P = xc["batch"], xc["seq"], 4, 384
    f_g = torch.randn(B_, S_, H_, generator=gen, device=dev)
    ssd_case("ssd_scan_mlstm_hd384", randn(B_, S_, H_, P),
             F.logsigmoid(f_g).requires_grad_(),
             randn(B_, S_, H_, P, scale=P ** -0.5), randn(B_, S_, H_, P),
             False, "xlstm-125m's mLSTM, the wide route",
             "ssd_scan wide route")
    return out


def flash_cross_row(dev, launches, backward_ms) -> dict:
    """flash_attention without a mask at whisper-medium's cross-attention in
    training: q (4, 448, 16, 64) over k, v (4, 1500, 16, 64) bf16, against
    its plain version, timed beside it and non-causal
    ``scaled_dot_product_attention``; ``launches`` are the whisper train
    steps' cross-attention ones, ``backward_ms`` one plain backward's time
    at this shape (``train_kernel_checks``)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import flash_attention as fa_mod
    from repro_torch.models import get_config

    c, w = get_config("whisper-medium"), TRAIN_WHISPER
    gen = torch.Generator(device=dev).manual_seed(SEED + 22)
    q_shape = (w["batch"], w["seq"], c.n_heads, c.head_dim)
    kv_shape = (w["batch"], c.encoder_len, c.n_heads, c.head_dim)
    q, k, v = (torch.randn(s_, generator=gen, device=dev).to(torch.bfloat16)
               for s_ in (q_shape, kv_shape, kv_shape))
    got = fa_mod.flash_attention(q, k, v, causal=False)
    qf, kf, vf = q.float(), k.float(), v.float()
    err = check_close("flash_attention_cross_whisper vs plain", got,
                      ref.flash_attention_ref(qf, kf, vf, causal=False))

    def call():
        return fa_mod.flash_attention(q, k, v, causal=False)
    ms, call_ms = time_ms(call), time_ms(call, hold=False)
    host = host_ms(call)
    plain_ms = time_ms(lambda: ref.flash_attention_ref(qf, kf, vf,
                                                       causal=False), runs=10)
    del qf, kf, vf
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    check_close("flash_attention_cross_whisper: SDPA vs the kernel",
                F.scaled_dot_product_attention(qt, kt, vt).transpose(1, 2),
                got)
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt))
    B_, Sq, H_, hd = q_shape
    sass = fa_mod.mma_instances(_build.sass_opcodes("flash_attention"))
    ptxas = fa_mod.mma_instances(_build.ptxas_report("flash_attention"))
    return dict(
        name="flash_attention_cross_whisper", tpu="flash_attention.py:122",
        design="mma.sync bf16, no mask, Sq != Sk",
        build=mma_build("flash_attention_cross_whisper", ptxas[hd], sass[hd]),
        shapes=f"q {q_shape}, k, v {kv_shape} bf16, causal=False "
               "(whisper-medium's cross-attention in training); library: "
               f"scaled_dot_product_attention, no mask; one plain backward "
               f"{backward_ms:.3f} ms",
        err=err, tol=f"tol {TOL} abs + {TOL} rel", ms=ms, call_ms=call_ms,
        host_ms=host, plain_ms=plain_ms,
        flops=4.0 * B_ * H_ * hd * Sq * kv_shape[1],
        nbytes=moved_bytes(q, k, v, got), lib_ms=lib_ms, launches=launches)


def _flash_routes():
    """The flash entry points the models call, as ``train_family`` counts
    them: the layers' (causal, or the encoder's non-causal self-attention)
    and the enc-dec's cross-attention."""
    from repro_torch.models import encdec
    from repro_torch.models import layers as L
    return [(L, "flash_attention",
             lambda a, k: "flash causal" if k.get("causal", True)
             else "flash non-causal"),
            (encdec, "flash_attention", lambda a, k: "flash cross")]


def train_phase(dev, card, peak_flops, out_dir) -> tuple[dict, list]:
    """Training at full width on the card: xlstm-125m (40 steps, checkpoint
    and resume), zamba2-2.7b, qwen2-moe-a2.7b, whisper-medium and
    internvl2-76b (each held against the plain versions, 3 steps), then one
    plain backward of each kernel timed at the path's shapes.  Returns, by
    kernel row name, the phase's launches by direction and family and the
    plain backward's time; and the row of flash at whisper's
    cross-attention."""
    import shutil
    import tempfile
    import time

    import torch
    from repro_torch.models import get_config

    t0 = time.perf_counter()
    root = out_dir or tempfile.gettempdir()
    os.makedirs(root, exist_ok=True)
    ckpt_dir = tempfile.mkdtemp(prefix="train_ckpt_", dir=root)
    try:
        xl = train_xlstm(dev, card, peak_flops, ckpt_dir)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)  # a 1.3 GB file
    gc.collect()
    torch.cuda.empty_cache()
    print(f"train xlstm-125m: {time.perf_counter() - t0:.1f} s of wall time")
    families = {}
    for label, t, cut in (("zamba2-2.7b", TRAIN_ZAMBA, None),
                          ("qwen2-moe-a2.7b", TRAIN_MOE, "layers"),
                          ("whisper-medium", TRAIN_WHISPER, None),
                          ("internvl2-76b", TRAIN_INTERNVL, "layers")):
        t1 = time.perf_counter()
        full = get_config(label)
        cfg = full.replace(n_layers=t[cut]) if cut else None
        if cut:
            print(f"train {label} reduced: depth {t[cut]} of {full.n_layers} "
                  "layers (the AdamW state of one card); widths as published")
        kernels = ("flash_attention", "ssd_scan") \
            if label == "zamba2-2.7b" else ("flash_attention",)
        families[label] = train_family(
            dev, card, peak_flops, label, t, kernels, cfg=cfg,
            routes=None if label == "zamba2-2.7b" else _flash_routes())
        gc.collect()
        torch.cuda.empty_cache()
        print(f"train {label}: {time.perf_counter() - t1:.1f} s of wall time")
    wh = families["whisper-medium"]["routes"]
    if not (wh.get("flash non-causal", 0) > 0 and wh.get("flash cross", 0) > 0
            and wh.get("flash causal", 0) > 0):
        raise RuntimeError(f"train whisper-medium: a flash route did not "
                           f"launch: {wh}")
    bwd = train_kernel_checks(dev)
    for name, row in bwd.items():
        print(f"[{card}] {name} at {row['shapes']}: forward max abs err "
              f"{row['err']:.4g} (tol {TOL} abs + {TOL} rel); the Function's "
              f"gradients vs plain autograd's, relative L2 " + ", ".join(
                  f"d{n} {g:.3g}" for n, g in row["gaps"].items())
              + f" (bound {FN_GRAD_TOL}); launches {row['launches']}; one "
              f"plain backward {row['ms']:.3f} ms (CUDA-event median of 5)")
    gc.collect()
    torch.cuda.empty_cache()
    xlz, zbz = xl["launches"], families["zamba2-2.7b"]["launches"]
    # the wide SSD at the train path's shape, where its forwards run
    rows = [flash_cross_row(dev, wh["flash cross"],
                            bwd["flash_attention_cross_whisper"]["ms"]),
            ssd_mlstm_row(dev, xlz["ssd_scan wide route"],
                          batch=TRAIN_XLSTM["batch"], seq=TRAIN_XLSTM["seq"],
                          name="ssd_scan_mlstm_hd384_train",
                          launches_of=f"xlstm-125m's {TRAIN_XLSTM['steps']} "
                                      "train steps, forward")]
    print(f"train phase: {time.perf_counter() - t0:.1f} s of wall time")
    by_family = {label: dict(forward=f["launches"]["flash_attention"],
                             backward_plain=f["launches"][
                                 "flash_attention backward (plain)"],
                             **({"routes": f["routes"]} if f["routes"]
                                else {}))
                 for label, f in families.items()}
    return {
        "flash_attention": dict(
            forward=sum(f["forward"] for f in by_family.values()),
            backward_plain=sum(f["backward_plain"]
                               for f in by_family.values()),
            by_family=by_family,
            plain_backward_ms=bwd["flash_attention"]["ms"],
            of="3 steps each of zamba2-2.7b, qwen2-moe-a2.7b, "
               "whisper-medium and internvl2-76b"),
        "flash_attention_noncausal_whisper": dict(
            forward=wh["flash non-causal"],
            of="whisper-medium's 3 steps, the encoder's self-attention"),
        "flash_attention_cross_whisper": dict(
            forward=wh["flash cross"],
            backward_plain=families["whisper-medium"]["launches"][
                "flash_attention backward (plain)"],
            plain_backward_ms=bwd["flash_attention_cross_whisper"]["ms"],
            of="whisper-medium's 3 steps, the cross-attention (backward: "
               "every route of the steps)"),
        "ssd_scan": dict(
            forward=zbz["ssd_scan"],
            backward_plain=zbz["ssd_scan backward (plain)"],
            plain_backward_ms=bwd["ssd_scan"]["ms"],
            of=f"zamba2-2.7b's {TRAIN_ZAMBA['steps']} steps"),
        "ssd_scan_mlstm_hd384": dict(
            forward=xlz["ssd_scan wide route"],
            backward_plain=xlz["ssd_scan backward (plain)"],
            plain_backward_ms=bwd["ssd_scan_mlstm_hd384"]["ms"],
            of=f"xlstm-125m's {TRAIN_XLSTM['steps']} steps (the resumed "
               "ones not counted)"),
        "decode_attention": dict(forward=0, backward_plain=0,
                                 of="training never decodes"),
    }, rows


# the dry-run's cells: (arch, shape, multi_pod)
MESH_CELLS = [("zamba2-2.7b", "train_4k", False),
              ("granite-8b", "decode_32k", True)]
MESH_ZAMBA = dict(steps=2, batch=2, seq=2048)
MESH_GRANITE = dict(batch=8, prompt=1024, new=16)
# The sharded steps on the card's 1 x 1 mesh against the unsharded ones:
# equal bit for bit.  Decided before the first run on the card: every
# placement on a mesh of one rank is local, DTensor issues no collective
# for a mesh dimension of size 1, and each operator runs on the whole
# tensor as the unsharded step runs it (the kernels through local_map on
# the same tensors); CPU runs of reduced configs gave equal numbers.


def mesh_dryrun(card, out_dir) -> list:
    """The dry-run's cells on the host (``meta`` DTensors over the fake
    512-rank group): records, the roofline tables, ``dryrun_torch.json``."""
    from repro_torch.configs.base import shape_by_name
    from repro_torch.launch import dryrun, roofline

    records = []
    for arch, shape, multi_pod in MESH_CELLS:
        t0 = time.perf_counter()
        rec = dryrun.run_cell(arch, shape_by_name(shape), multi_pod=multi_pod)
        rec["wall_s"] = time.perf_counter() - t0
        records.append(rec)
        if rec["status"] != "OK":
            raise RuntimeError(f"dry-run {arch} x {shape}: {rec['status']} "
                               f"{rec.get('error')}\n{rec.get('trace')}")
        a = roofline.analyse(rec)
        mem = rec["memory"]
        print(f"mesh dry-run {arch} x {shape} x {rec['mesh']} "
              f"({rec['n_devices']} ranks, traced on the host in "
              f"{rec['wall_s']:.1f} s): per device "
              f"{rec['hlo_flops_per_device']:.4e} FLOP, "
              f"{rec['hlo_bytes_per_device']:.4e} B, collectives "
              + ", ".join(f"{k} {v:.4e} B" for k, v in
                          rec["collectives"].items())
              + f"; arguments {mem['argument_bytes'] / 2**30:.3f} GiB, "
              f"temporaries {mem['temp_bytes'] / 2**30:.3f} GiB; useful-FLOPs "
              f"ratio {a['useful_flops_ratio']:.4f}; roofline terms (H100 "
              f"data sheet) compute {a['t_compute_s'] * 1e3:.3f} ms, memory "
              f"{a['t_memory_s'] * 1e3:.3f} ms, collective "
              f"{a['t_collective_s'] * 1e3:.3f} ms, dominant {a['dominant']}")
        if not (rec["hlo_flops_per_device"] > 0 and
                rec["hlo_bytes_per_device"] > 0 and
                mem["argument_bytes"] > 0 and mem["temp_bytes"] > 0):
            raise RuntimeError(f"dry-run {arch} x {shape}: an empty count")
        if shape.startswith("train") and not \
                rec["collective_bytes_per_device"] > 0:
            raise RuntimeError(f"dry-run {arch} x {shape}: no collective")
    for mesh in ("16x16", "2x16x16"):
        print(f"roofline over the dry-run, mesh {mesh} (data-sheet "
              f"figures of {card.split(',')[0]}):")
        print(roofline.table(records, mesh))
    if out_dir:
        path = os.path.join(out_dir, "dryrun_torch.json")
        with open(path, "w") as f:
            json.dump(records, f, indent=1)
        print(f"wrote {path}")
    return records


def _host(tree) -> list:
    """Every leaf's local tensor, copied to the host."""
    from repro_torch.models import layers as L
    return [(t.to_local() if hasattr(t, "to_local") else t).cpu()
            for t in L.tree_leaves(tree)]


def mesh_zamba(dev, card, mesh) -> dict:
    """zamba2-2.7b at full size: ``MESH_ZAMBA["steps"]`` unsharded train
    steps, then as many through the mesh from the same seed (parameters
    and moments DTensors wrapping the same kind of tensors, no copy); the
    losses and the parameters after the last step must be equal bit for
    bit, and flash_attention and ssd_scan must launch inside the mesh."""
    import torch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.launch.steps import make_train_step, rules_for, \
        shard_args
    from repro_torch.optim import AdamWConfig, init_state

    t = MESH_ZAMBA
    label = "zamba2-2.7b"
    shape = ShapeConfig("mesh_train", t["seq"], t["batch"], "train")
    rules = rules_for(shape, multi_pod=False)
    runs = {}
    for sharded in (False, True):
        model, params = lm_model(label, dev)
        data = SyntheticLM(DataConfig(vocab=model.cfg.vocab, seq_len=t["seq"],
                                      global_batch=t["batch"], seed=SEED))
        opt = init_state(params)
        kw, prepare = {}, None
        if sharded:
            args = shard_args(model.cfg, shape, mesh, rules,
                              {"params": params, "opt_state": opt})
            params, opt = args["params"], args["opt_state"]
            kw = dict(rules=rules, mesh=mesh)

            def prepare(batch):
                return shard_args(model.cfg, shape, mesh, rules,
                                  {"batch": batch})["batch"]
        start = kernel_launches()
        params, opt, run = train_steps(
            model, make_train_step(model, AdamWConfig(), **kw), params, opt,
            data, 0, t["steps"], prepare=prepare)
        run["launches"] = kernel_launches(start)
        run["params"] = _host(params)
        runs[sharded] = run
        del model, params, opt
        gc.collect()
        torch.cuda.empty_cache()
    plain, mesh_run = runs[False], runs[True]
    for name, run in (("unsharded", plain), ("1 x 1 mesh", mesh_run)):
        print(f"[{card}] mesh {label} train, {name}: step "
              f"{run['step_ms']:.1f} ms (forward + loss {run['fwd_ms']:.1f}, "
              f"backward {run['bwd_ms']:.1f}, AdamW {run['opt_ms']:.1f}; "
              f"CUDA-event medians over {t['steps']} steps of {t['batch']} x "
              f"{t['seq']} tokens); peak memory {run['peak_gb']:.2f} GB; "
              f"losses " + ", ".join(f"{v:.6f}" for v in run["losses"])
              + f"; launches {run['launches']}")
    same = sum(torch.equal(a, b) for a, b in zip(plain["params"],
                                                  mesh_run["params"]))
    print(f"[{card}] mesh {label} train: losses equal "
          f"{plain['losses'] == mesh_run['losses']}; {same} of "
          f"{len(plain['params'])} parameter leaves equal bit for bit after "
          f"step {t['steps']}; DTensor's host cost "
          f"{mesh_run['step_ms'] - plain['step_ms']:.1f} ms a step")
    if plain["losses"] != mesh_run["losses"] or same != len(plain["params"]):
        raise RuntimeError(f"mesh {label}: the sharded steps differ from the "
                           "unsharded ones")
    launches = mesh_run["launches"]
    for k in ("flash_attention", "ssd_scan",
              "flash_attention backward (plain)",
              "ssd_scan backward (plain)"):
        if launches[k] <= 0:
            raise RuntimeError(f"mesh {label}: no {k} launch in the mesh")
    return dict(launches=launches, step_ms=mesh_run["step_ms"],
                plain_step_ms=plain["step_ms"])


def mesh_granite(dev, card, mesh) -> dict:
    """granite-8b at full size: the prefill over ``MESH_GRANITE["batch"]``
    prompts of ``MESH_GRANITE["prompt"]`` tokens and ``["new"]`` greedy
    decode steps, unsharded and then through the mesh (the decode steps
    under ``rules_for(decode_32k)``) on the same weights; logits bit for
    bit and tokens equal, and flash_attention and decode_attention must
    launch inside the mesh."""
    import torch
    from repro_torch.configs.base import DECODE_32K, ShapeConfig
    from repro_torch.launch.steps import (make_decode_step,
                                          make_prefill_step, rules_for,
                                          shard_args)

    g = MESH_GRANITE
    label = "granite-8b"
    model, params = lm_model(label, dev)
    max_len = g["prompt"] + g["new"]
    pshape = ShapeConfig("mesh_prefill", max_len, g["batch"], "prefill")
    dshape = ShapeConfig("mesh_decode", max_len, g["batch"], "decode")
    prules = rules_for(pshape, multi_pod=False)
    drules = rules_for(DECODE_32K, multi_pod=False)
    gen = torch.Generator().manual_seed(SEED)
    tokens = torch.randint(0, model.cfg.vocab, (g["batch"], g["prompt"]),
                           generator=gen, dtype=torch.int32).to(dev)
    runs = {}
    for sharded in (False, True):
        cache = model.init_cache(g["batch"], max_len)
        p, batch = params, {"tokens": tokens}
        prefill, decode = make_prefill_step(model), make_decode_step(model)
        if sharded:
            a = shard_args(model.cfg, pshape, mesh, prules,
                           {"params": params, "cache": cache,
                            "batch": batch})
            p, cache, batch = a["params"], a["cache"], a["batch"]
            prefill = make_prefill_step(model, rules=prules, mesh=mesh)
            decode = make_decode_step(model, rules=drules, mesh=mesh)
        pre_clock, dec_clock = StepClock(), StepClock()
        prefill, decode = pre_clock.wrap(prefill), dec_clock.wrap(decode)
        start = kernel_launches()
        outs, toks = [], []
        with torch.no_grad():
            logits, cache = prefill(p, cache, batch)
            outs.append(logits)
            tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
            tok = tok[:, None]
            for i in range(g["new"]):
                d = {"token": tok.full_tensor() if sharded else tok,
                     "cache_len": torch.tensor(g["prompt"] + i,
                                               dtype=torch.int32, device=dev)}
                if sharded:
                    d = shard_args(model.cfg, dshape, mesh, drules, d)
                tok, logits, cache = decode(p, cache, d["token"],
                                            d["cache_len"])
                outs.append(logits)
                toks.append(tok.full_tensor() if sharded else tok)
        runs[sharded] = dict(
            logits=[o.full_tensor() if sharded else o for o in outs],
            tokens=torch.cat(toks, dim=1), launches=kernel_launches(start),
            prefill_ms=pre_clock.ms()[0],
            decode_ms=statistics.median(dec_clock.ms()))
        del cache, outs
    plain, mesh_run = runs[False], runs[True]
    for name, run in (("unsharded", plain), ("1 x 1 mesh", mesh_run)):
        print(f"[{card}] mesh {label} serve, {name}: prefill of "
              f"{g['batch']} x {g['prompt']} tokens {run['prefill_ms']:.1f} "
              f"ms, decode step {run['decode_ms']:.2f} ms (CUDA-event median "
              f"of {g['new']}); launches {run['launches']}")
    same = sum(torch.equal(a, b) for a, b in zip(plain["logits"],
                                                  mesh_run["logits"]))
    worst = max((a.float() - b.float()).abs().max().item()
                for a, b in zip(plain["logits"], mesh_run["logits"]))
    toks_same = torch.equal(plain["tokens"], mesh_run["tokens"])
    print(f"[{card}] mesh {label} serve: {same} of {len(plain['logits'])} "
          f"logits tensors equal bit for bit (largest difference "
          f"{worst:.4g}); greedy tokens equal {toks_same}")
    if same != len(plain["logits"]) or not toks_same:
        raise RuntimeError(f"mesh {label}: the sharded steps differ from the "
                           "unsharded ones")
    launches = mesh_run["launches"]
    for k in ("flash_attention", "decode_attention"):
        if launches[k] <= 0:
            raise RuntimeError(f"mesh {label}: no {k} launch in the mesh")
    del model, params
    return dict(launches=launches, prefill_ms=mesh_run["prefill_ms"],
                decode_ms=mesh_run["decode_ms"])


# the split-decode check: granite-8b x decode_32k's rows of one rank on the
# 2 x 16 x 16 mesh (128 sequences over pod x data: 4 rows; 32,768-entry
# caches cut over the 16 model ranks into slices of 2048), and gemma2-9b's
# local layer at the same cut, its window's lower edge inside a slice
SPLIT = dict(batch=4, max_len=32768, shards=16)
SPLIT_LENGTHS = {"granite-8b": [32768, 30000, 16384, 2049],
                 "gemma2-9b": [30000, 17000, 9000, 4096]}


def split_decode_case(dev, card, arch) -> dict:
    """``arch``'s attention over a cache cut into ``SPLIT["shards"]``
    slices of its sequence, as each rank of a mesh holds it: the kernel on
    each slice with the slice's lengths and starts (``sharded
    .slice_bounds``) and its log-sum-exp, then ``combine_partials`` on the
    stacked partials (one card: the combine the ranks' collectives make,
    here on stacked tensors).  Held against the unsplit kernel and the
    plain version (``check_decode``), and the slices' lse against the plain
    version's; the slice calls' launches counted from 0.  Returns the
    numbers and the inputs of the heaviest slice."""
    import torch
    from repro_torch.kernels import decode_attention as da_mod
    from repro_torch.kernels import ref
    from repro_torch.kernels.sharded import slice_bounds
    from repro_torch.models import get_config

    c, sp = get_config(arch), SPLIT
    window = c.window
    gen = torch.Generator(device=dev).manual_seed(SEED + 31)
    B, Smax, R = sp["batch"], sp["max_len"], sp["shards"]
    q = torch.randn((B, c.n_heads, c.head_dim), generator=gen, device=dev,
                    dtype=torch.bfloat16)
    k, v = (torch.randn((B, Smax, c.n_kv_heads, c.head_dim), generator=gen,
                        device=dev, dtype=torch.bfloat16) for _ in range(2))
    lens = torch.tensor(SPLIT_LENGTHS[arch], dtype=torch.int32, device=dev)
    Sl = Smax // R
    bounds = [slice_bounds(lens, r * Sl, Sl, window) for r in range(R)]
    kw = dict(softcap=c.attn_softcap)

    def slices():
        return [da_mod.decode_attention(
            q, k[:, r * Sl:(r + 1) * Sl], v[:, r * Sl:(r + 1) * Sl], end,
            starts=start, return_lse=True, **kw)
            for r, (end, start) in enumerate(bounds)]

    start = kernel_launches()
    parts = slices()
    launches = kernel_launches(start)["decode_attention"]
    if launches != R:
        raise RuntimeError(f"split decode {arch}: {launches} launches for "
                           f"{R} slices")
    got = ref.combine_partials(torch.stack([o for o, _ in parts]),
                               torch.stack([lse for _, lse in parts]))
    whole = da_mod.decode_attention(q, k, v, lens, window=window, **kw)
    qf, kf, vf = q.float(), k.float(), v.float()
    want = ref.decode_attention_ref(qf, kf, vf, lens, window=window, **kw)
    err, rel = check_decode(f"split decode {arch} vs plain", got, want, want)
    err_k, rel_k = check_decode(f"split decode {arch} vs the unsplit kernel",
                                got, whole, want)
    lse_err = 0.0
    for r, (o, lse) in enumerate(parts):
        end, start = bounds[r]
        _, lse_want = ref.decode_attention_ref(
            qf, kf[:, r * Sl:(r + 1) * Sl], vf[:, r * Sl:(r + 1) * Sl], end,
            starts=start, return_lse=True, **kw)
        empty = torch.isneginf(lse_want)
        if not torch.equal(torch.isneginf(lse), empty):
            raise RuntimeError(f"split decode {arch}: slice {r}'s empty rows "
                               "differ from the plain version's")
        if (~empty).any():
            lse_err = max(lse_err, check_close(
                f"split decode {arch} slice {r} lse vs plain", lse[~empty],
                lse_want[~empty], atol=1e-3, rtol=1e-3))
    del kf, vf

    def split_call():
        ps = slices()
        return ref.combine_partials(torch.stack([o for o, _ in ps]),
                                    torch.stack([lse for _, lse in ps]))
    split_ms = time_ms(split_call)
    slices_ms = time_ms(slices)
    whole_ms = time_ms(lambda: da_mod.decode_attention(
        q, k, v, lens, window=window, **kw))
    heavy = max(range(R), key=lambda r: int(bounds[r][0].sum()
                                            - bounds[r][1].sum()))
    print(f"[{card}] split decode {arch}: q {tuple(q.shape)}, k, v "
          f"{tuple(k.shape)} bf16 cut into {R} slices of {Sl}, lengths "
          f"{SPLIT_LENGTHS[arch]}, window {window}, softcap {c.attn_softcap}; "
          f"combined vs plain max abs err {err:.4g} (relative norm "
          f"{rel:.4g}), vs the unsplit kernel {err_k:.4g} ({rel_k:.4g}); "
          f"bounds {DEC_ATOL} x RMS abs + {DEC_RTOL} rel, norm {DEC_NORM}; "
          f"slices' lse vs plain max abs err {lse_err:.4g} (1e-3); "
          f"{R} slice calls {slices_ms:.4f} ms, with combine_partials "
          f"{split_ms:.4f} ms, one unsplit call {whole_ms:.4f} ms "
          f"(CUDA-event medians); {launches} launches")
    return dict(launches=launches, err=err, rel=rel, err_kernel=err_k,
                split_ms=split_ms, slices_ms=slices_ms, whole_ms=whole_ms,
                lse_err=lse_err, q=q, k=k[:, heavy * Sl:(heavy + 1) * Sl],
                v=v[:, heavy * Sl:(heavy + 1) * Sl], bounds=bounds[heavy],
                slice=heavy, softcap=c.attn_softcap)


def split_decode_row(dev, case) -> dict:
    """The decode kernel with ``starts`` and ``return_lse`` at one slice of
    the granite-8b case (the one with the most valid keys): held against
    its plain version, timed beside it and beside PyTorch's memory-efficient
    attention asked for its log-sum-exp (the same two outputs); launches:
    the check's slice calls."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels import decode_attention as da_mod
    from repro_torch.kernels import ref

    q, k, v, (end, start) = case["q"], case["k"], case["v"], case["bounds"]
    B, H, hd = q.shape
    Sl, Hk = k.shape[1], k.shape[2]

    def call():
        return da_mod.decode_attention(q, k, v, end, starts=start,
                                       return_lse=True)
    got, lse = call()
    qf, kf, vf = q.float(), k.float(), v.float()
    want, _ = ref.decode_attention_ref(qf, kf, vf, end, starts=start,
                                       return_lse=True)
    err, rel = check_decode("decode_attention_lse_slice_granite vs plain",
                            got, want, want)
    ms, call_ms = time_ms(call), time_ms(call, hold=False)
    host = host_ms(call)
    plain_ms = time_ms(lambda: ref.decode_attention_ref(
        qf, kf, vf, end, starts=start, return_lse=True), runs=10)
    del kf, vf
    kpos = torch.arange(Sl, device=q.device)
    mask = (kpos[None, :] < end[:, None]) & (kpos[None, :] >= start[:, None])
    kt, vt = (t.transpose(1, 2).repeat_interleave(H // Hk, dim=1)
              .contiguous() for t in (k, v))
    bias = torch.zeros((B, H, 1, Sl), dtype=q.dtype, device=q.device)
    bias.masked_fill_(~mask[:, None, None, :], float("-inf"))
    qv = q.view(B, H, 1, hd)

    def lib():
        return torch.ops.aten._scaled_dot_product_efficient_attention(
            qv, kt, vt, bias, True)
    lib_ms, lib_note = None, ""
    try:
        out = lib()
        check_decode("decode_attention_lse_slice_granite: efficient "
                     "attention vs plain", out[0].reshape(q.shape), want, want)
        lib_ms = time_ms(lib)
        lib_note = ("PyTorch's memory-efficient attention with the mask as a "
                    "bias, compute_log_sumexp=True")
    except (RuntimeError, TypeError) as e:     # no such kernel here
        lib_note = f"none ran ({type(e).__name__}: {str(e)[:120]})"
    rows = int(mask.sum())
    build = mma_build("decode_attention_lse_slice_granite",
                      [da_mod.mma_instances(
                          _build.ptxas_report("decode_attention"))[hd]],
                      [da_mod.mma_instances(
                          _build.sass_opcodes("decode_attention"))[hd]])
    plan = da_mod.split_plan(q, k)
    return dict(
        name="decode_attention_lse_slice_granite",
        tpu="decode_attention.py:100",
        design="mma.sync bf16, split-KV, one wave; per-row starts and the "
               "log-sum-exp",
        build=dict(**build, nsplit=plan["nsplit"],
                   ctas_per_sm=plan["ctas_per_sm"],
                   smem_bytes=plan["smem_bytes"]),
        shapes=f"q {tuple(q.shape)} bf16, k, v {tuple(k.shape)} bf16 (slice "
               f"{case['slice']} of {SPLIT['shards']} of granite-8b x "
               f"decode_32k's 32,768-entry caches), lengths {end.tolist()}, "
               f"starts {start.tolist()}, lse (B, H) fp32; relative norm err "
               f"{rel:.4g}; library: {lib_note}",
        err=err, tol=f"tol {DEC_ATOL} x RMS abs + {DEC_RTOL} rel, norm "
                     f"{DEC_NORM}",
        ms=ms, call_ms=call_ms, host_ms=host, plain_ms=plain_ms,
        flops=4.0 * H * hd * rows,
        nbytes=moved_bytes(q, got, lse, end, start) + 2.0 * rows * Hk * hd * 2,
        lib_ms=lib_ms, launches=case["launches"],
        launches_of="the split-decode check's slice calls (granite-8b)")


def mesh_phase(dev, card, out_dir) -> tuple[dict, list]:
    """The launch slice: the dry-run's cells on the host, then zamba2-2.7b
    trained and granite-8b served through the sharded steps on a 1 x 1
    ``DeviceMesh`` of the card (NCCL), each against its unsharded steps;
    then the split-decode check (``split_decode_case``) at granite-8b's
    and gemma2-9b's widths.  Returns each kernel's launches in the mesh, by
    path, and the row of the decode kernel with its log-sum-exp."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_smoke_mesh

    t0 = time.perf_counter()
    mesh_dryrun(card, out_dir)
    dist.destroy_process_group()        # the fake group of the dry-run
    print(f"mesh dry-run: {time.perf_counter() - t0:.1f} s of wall time")
    mesh = make_smoke_mesh(dev)
    try:
        t1 = time.perf_counter()
        zb = mesh_zamba(dev, card, mesh)
        print(f"mesh zamba2-2.7b: {time.perf_counter() - t1:.1f} s of wall "
              "time")
        t1 = time.perf_counter()
        gr = mesh_granite(dev, card, mesh)
        print(f"mesh granite-8b: {time.perf_counter() - t1:.1f} s of wall "
              "time")
    finally:
        dist.destroy_process_group()
        gc.collect()
        torch.cuda.empty_cache()
    t1 = time.perf_counter()
    split = {arch: split_decode_case(dev, card, arch)
             for arch in SPLIT_LENGTHS}
    rows = [split_decode_row(dev, split["granite-8b"])]
    del split
    torch.cuda.empty_cache()
    print(f"mesh split decode: {time.perf_counter() - t1:.1f} s of wall "
          "time")
    print(f"mesh phase: {time.perf_counter() - t0:.1f} s of wall time")
    z, g = zb["launches"], gr["launches"]
    return {
        "flash_attention": {"zamba2-2.7b train": z["flash_attention"],
                            "granite-8b serve": g["flash_attention"]},
        "ssd_scan": {"zamba2-2.7b train": z["ssd_scan"]},
        "decode_attention": {"granite-8b serve": g["decode_attention"]},
    }, rows


def rel_err(got, want) -> float:
    """Relative norm error of ``got`` against ``want`` (in float64)."""
    import torch
    got, want = got.double().cpu(), want.double().cpu()
    return (torch.linalg.vector_norm(got - want)
            / torch.linalg.vector_norm(want)).item()


def run_blocks(fns, x) -> list:
    """Every block boundary's tensor of a chain of block callables."""
    outs = []
    for f in fns:
        x = f(x)
        outs.append(x)
    return outs


def device_busy_ms(fn) -> float:
    """Device time (ms) of the kernels one call of ``fn()`` launches, from
    ``torch.profiler``; 0.0 where the profiler sees no device time.  The
    device copies of ``record_function`` ranges (the port's spans among
    them) are user annotations, not device work, and are left out."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == DeviceType.CUDA
               and not e.is_user_annotation) / 1e3


def zoo_net(name, dev, peak_fp32, peak_bw) -> dict:
    """One zoo net at full size on the card: its blocks timed on the
    five-tier testbed, the 4G query, the chosen partitions against the
    whole graph (bit for bit), every block boundary against the port's CPU
    run of the same weights, and the whole graph timed."""
    import torch
    from benchmarks import common_torch as ct
    from repro_torch.core import (CompiledCostProvider, Query, Resource,
                                  fuse_blocks)
    from repro_torch.core.resources import H100_SXM
    from repro_torch.models import cnn_zoo
    from repro_torch.runtime import PipelineExecutor

    torch.cuda.reset_peak_memory_stats(dev)
    graph = cnn_zoo.build(name, dev, seed=SEED)
    blocks = fuse_blocks(graph)
    fns = [b.make_callable() for b in blocks]
    gen = torch.Generator().manual_seed(SEED)
    x_cpu = torch.randn(graph.input_spec.shape, generator=gen)
    x = x_cpu.to(dev)

    # Steps 2-6 on the five tiers, fresh (no cache)
    s = ct.scission_for("4g", device=dev)
    db = s.benchmark(graph)
    res = s.query(name, Query(top_n=20))
    cloud = [r.mean_time_s for r in db.records["cloud"]]
    slow = sorted(range(len(cloud)), key=cloud.__getitem__)[-3:][::-1]

    # the chosen partition and the best staged one against the whole graph
    outs = run_blocks(fns, x)
    whole = outs[-1]
    staged = next((c for c in res.configs[1:] if len(c.segments) > 1),
                  None)
    runs = {"best": res.best} if staged is None else {
        "best": res.best, "staged": staged}
    for label, cfg in runs.items():
        y, _ = PipelineExecutor(graph, cfg, s.network, source="device",
                                device=dev).run(x)
        if y.shape != whole.shape or not torch.equal(y, whole):
            raise RuntimeError(f"zoo {name}: the {label} partition "
                               f"{cfg.describe()} differs from the "
                               "whole-graph run")

    # one whole-graph call: CUDA events on an idle device, and the kernels'
    # device time under the profiler (timed before the CPU run below, whose
    # worker threads would compete with the host's launches)
    def call():
        return run_blocks(fns, x)[-1]

    call_ms, busy = time_ms(call, hold=False), device_busy_ms(call)

    # every block boundary against the port's CPU run of the same weights
    ref = cnn_zoo.build(name, "cpu", seed=SEED)
    ref_outs = run_blocks([b.make_callable() for b in fuse_blocks(ref)],
                          x_cpu)
    errs = [rel_err(o, r) for o, r in zip(outs, ref_outs)]
    worst = max(range(len(errs)), key=errs.__getitem__)
    if not errs[worst] <= ZOO_TOL:
        raise RuntimeError(f"zoo {name}: block {worst} "
                           f"({blocks[worst].name}) differs from the CPU run "
                           f"by {errs[worst]:.3g} (relative norm; tol "
                           f"{ZOO_TOL})")
    del ref, ref_outs, outs

    # the roofline of the operators the blocks run, on the H100's fp32
    # (no tensor core) and HBM peaks
    h100 = Resource("cloud", "cloud", H100_SXM)
    costs = [CompiledCostProvider().measure(b, h100, 1) for b in blocks]
    flops = sum(c[2] for c in costs)
    nbytes = sum(c[3] for c in costs)
    row = dict(
        name=name, blocks=len(blocks), points=len(blocks) - 1,
        flops=flops, nbytes=nbytes, bound_ms=max(flops / peak_fp32,
                                                 nbytes / peak_bw) * 1e3,
        cloud_ms=sum(cloud) * 1e3, call_ms=call_ms, busy_ms=busy,
        idle=(1.0 - busy / call_ms) if busy else None,
        slowest=[(blocks[i].name, cloud[i] * 1e3) for i in slow],
        query_ms=res.query_time_s * 1e3, best=res.best.describe(),
        partitions=list(runs), max_err=errs[worst],
        mem_mb=torch.cuda.max_memory_allocated(dev) / 1e6)
    del graph, blocks, fns, whole, s, db
    torch.cuda.empty_cache()
    return row


def zoo_phase(dev, out_dir, peak_fp32, peak_bw) -> None:
    """The paper's six steps on the CNN zoo at full size (224x224x3 or
    299/331 inputs, batch 1, fp32 with TF32 off): the 18 nets timed and
    checked one at a time, ResNet50 partitioned as a block DAG, and
    MobileNetV2's 3G/4G decision from a DB timed on the card."""
    import torch
    from benchmarks import common_torch as ct
    from repro_torch.core import (PartitionConfig, Query, Segment,
                                  fuse_block_dag, fuse_blocks)
    from repro_torch.models import cnn_zoo
    from repro_torch.runtime import DagPipelineExecutor, PipelineExecutor

    flags = ct.fp32_flags()
    print(f"zoo flags {flags}; TIME_SCALE {ct.TIME_SCALE:.6g} (card "
          f"{ct.CARD_MOBILENETV2_S * 1e3:.4g} ms, CPU "
          f"{ct.CPU_MOBILENETV2_S * 1e3:.4g} ms for MobileNetV2)")

    # -- the 18 nets, one at a time -------------------------------------
    for name in cnn_zoo.ZOO:
        r = zoo_net(name, dev, peak_fp32, peak_bw)
        idle = f"{r['idle']:.3f}" if r["idle"] is not None else \
            "not measured"
        print(f"zoo {name}: {r['blocks']} blocks ({r['points']} points), "
              f"{r['flops'] / 1e9:.3f} GFLOP, {r['nbytes'] / 1e6:.1f} MB "
              f"accessed by the eager operators; whole graph {r['call_ms']:.4f} ms per call (CUDA "
              f"events), kernels busy {r['busy_ms']:.4f} ms of it "
              f"(profiler), idle share {idle}; bound "
              f"{r['bound_ms']:.4f} ms (fp32 {peak_fp32 / 1e12:.0f} TFLOP/s, "
              f"{peak_bw / 1e12:.2f} TB/s); sum of cloud block times "
              f"{r['cloud_ms']:.4f} ms, slowest "
              + ", ".join(f"{n} {t:.4f} ms" for n, t in r["slowest"])
              + f"; 4G query {r['query_ms']:.1f} ms, best {r['best']}; "
              f"partitions {r['partitions']} equal the whole graph; max "
              f"block rel err vs CPU {r['max_err']:.3g} (tol {ZOO_TOL}); "
              f"peak memory {r['mem_mb']:.1f} MB")

    # -- ResNet50 as a block DAG under 4G ---------------------------------
    graph = cnn_zoo.build("ResNet50", dev, seed=SEED)
    s = ct.scission_for("4g", device=dev)
    s.benchmark(graph, dag=True)
    res = s.query("ResNet50", Query(top_n=20))
    x = torch.randn(graph.input_spec.shape,
                    generator=torch.Generator().manual_seed(SEED)).to(dev)
    whole = run_blocks([b.make_callable() for b in fuse_blocks(graph)],
                       x)[-1]
    staged = next((c for c in res.configs[1:]
                   if len(set(c.assignment)) > 1), None)
    # every block edge across two resources, branch and skip edges too
    n = len(fuse_block_dag(graph))
    interleaved = PartitionConfig("ResNet50", tuple(
        Segment(("device", "cloud")[i % 2], i, i) for i in range(n)),
        0.0, {}, 0.0, 0.0)
    for label, cfg in (("best", res.best), ("staged", staged),
                       ("interleaved", interleaved)):
        if cfg is None:
            continue
        pipe = DagPipelineExecutor(graph, cfg, s.network, source="device",
                                   device=dev)
        y, timings = pipe.run(x, collect_timing=True)
        if not torch.equal(y, whole):
            raise RuntimeError(f"ResNet50 DAG {label} partition differs "
                               "from the whole-graph run")
        lat = pipe.simulated_latency(
            timings, {r.name: r.speed_factor for r in s.resources})
        crossing = sum(any(t.comm_in_s) for t in timings)
        print(f"zoo ResNet50 DAG ({len(pipe.dag)} blocks, query "
              f"{res.strategy} {res.query_time_s * 1e3:.1f} ms) {label}: "
              f"{cfg.describe()[:160]}; {crossing} blocks fed over a link; "
              f"equals the whole graph; simulated latency "
              f"{lat * 1e3:.3f} ms")
    del graph, s, x, whole
    torch.cuda.empty_cache()

    # -- MobileNetV2: the paper's six steps, timed twice ------------------
    graph = cnn_zoo.build("MobileNetV2", dev, seed=SEED)      # Step 1
    runs = []
    for _ in range(2):                          # two fresh DBs, Steps 2-3
        s3 = ct.scission_for("3g", device=dev)
        db = s3.benchmark(graph)
        s4 = ct.scission_for("4g", device=dev)
        s4.load(db)
        best = {net: sc.query("MobileNetV2", Query(top_n=3))   # Step 5
                for net, sc in (("3g", s3), ("4g", s4))}
        runs.append(dict(s3=s3, s4=s4, db=db, best=best,
                         tiers=ct.tier_times(db, s3.resources),
                         flip=ct.flip_range(db, s3.resources)))
    for i, r in enumerate(runs, 1):
        print(f"zoo MobileNetV2 DB {i} TimingProvider time, each tier's "
              "block times over its speed factor: " + ", ".join(
                  f"{k} {v * 1e3:.4f} ms" for k, v in r["tiers"].items())
              + f"; median {statistics.median(r['tiers'].values()) * 1e3:.4f}"
              f" ms (the calibration took {ct.CARD_MOBILENETV2_S * 1e3:.4f} "
              "ms)")
    s3, s4, db = runs[0]["s3"], runs[0]["s4"], runs[0]["db"]
    if out_dir:                                               # Step 4
        os.makedirs(out_dir, exist_ok=True)
        s3.save("MobileNetV2", os.path.join(out_dir,
                                            "chip_smoke_zoo_db.json"))
    x = torch.randn(graph.input_spec.shape,
                    generator=torch.Generator().manual_seed(SEED)).to(dev)
    whole = run_blocks([b.make_callable() for b in fuse_blocks(graph)],
                       x)[-1]
    for net, sc in (("3g", s3), ("4g", s4)):
        res = runs[0]["best"][net]
        y, _ = PipelineExecutor(graph, res.best, sc.network,  # Step 6
                                source="device", device=dev).run(x)
        if not torch.equal(y, whole):
            raise RuntimeError(f"MobileNetV2's best partition under {net} "
                               "differs from the whole-graph run")
        print(f"zoo MobileNetV2 [{net}] top-3 (query "
              f"{res.query_time_s * 1e3:.1f} ms): "
              + "; ".join(c.describe() for c in res.configs)
              + "; the best run stage by stage equals the whole graph")
    private = s4.query("MobileNetV2",
                       Query(top_n=1, exclude=("cloud", "cloud_gpu"))).best
    print(f"zoo MobileNetV2 [4g, privacy: no cloud] {private.describe()}")
    if {"cloud", "cloud_gpu"} & set(private.resources):
        raise RuntimeError("the privacy query placed a block on the cloud")

    # the checks: reproducible block times, the 3G decision, a flip over a
    # range of network scale factors, and one 4G verdict from both DBs
    spread = {k: abs(runs[0]["tiers"][k] - runs[1]["tiers"][k])
              / min(runs[0]["tiers"][k], runs[1]["tiers"][k])
              for k in runs[0]["tiers"]}
    print("zoo MobileNetV2 tier times, DB 1 against DB 2: " + ", ".join(
        f"{k} {v:.2%}" for k, v in spread.items())
        + f" apart (limit {ZOO_SPREAD:.0%})")
    if max(spread.values()) > ZOO_SPREAD:
        raise RuntimeError(f"MobileNetV2's tier times differ by more than "
                           f"{ZOO_SPREAD:.0%} between two fresh DBs: "
                           f"{spread}")
    for i, r in enumerate(runs, 1):
        lo, hi = r["flip"]
        b3, b4 = r["best"]["3g"].best, r["best"]["4g"].best
        print(f"zoo MobileNetV2 DB {i}: 3G {ct.verdict(b3)} "
              f"({b3.describe()}); 4G at scale 1 {ct.verdict(b4)} "
              f"({b4.describe()}); the flip (device-native under 3G, "
              f"cloud-native under 4G) holds for network scale factors "
              f"{lo:.4g}-{hi:.4g} on top of TIME_SCALE (1 = the "
              "calibration)")
        if ct.verdict(b3) != "device-native":
            raise RuntimeError(f"MobileNetV2 DB {i}: the best partition "
                               f"under 3G is not device-native: "
                               f"{b3.describe()}")
        if math.isnan(lo):
            raise RuntimeError(f"MobileNetV2 DB {i}: the decision flips at "
                               "no network scale factor")
    his = [r["flip"][1] for r in runs]
    if abs(his[0] - his[1]) / min(his) > ZOO_SPREAD:
        raise RuntimeError(f"the flip ranges' upper edges {his} differ by "
                           f"more than {ZOO_SPREAD:.0%}")
    verdicts = [ct.verdict(r["best"]["4g"].best) for r in runs]
    if verdicts[0] != verdicts[1]:
        raise RuntimeError(f"the 4G verdict at scale 1 differs between two "
                           f"fresh DBs: {verdicts}")


def paper_phase(dev) -> None:
    """The paper's benchmarks on the card, through the port's harness
    modules: ``bench_partitions_torch``'s smoke modes (Figs 6-8's
    decisions, predicted against simulated throughput, the Pareto frontier
    against the exhaustive oracle, binding constraints, the fleet-sized
    frontier and incremental re-plans, and the DAG-general gate on the
    branchy MoE layer and enc-dec LM: SP lattice against the DAG-aware
    oracle, parallel-region splits), ``bench_serving_torch``'s smoke
    (Poisson and bursty traces through the router at the frontier's
    highest-throughput point, goodput within 30% of predicted, a live
    re-plan) and ``bench_query_torch`` in quick mode (the worst query
    under 50 ms).  Their DBs are timed afresh on ``dev`` into a cache of
    this run's own; any gate failure raises, and so does a launch of a
    hand-written kernel by the zoo's benchmarks, or no flash_attention
    launch by the DAG gate's enc-dec LM."""
    import shutil
    from benchmarks import bench_partitions_torch as bp
    from benchmarks import bench_query_torch as bq
    from benchmarks import bench_serving_torch as bs
    from benchmarks import common_torch as ct

    t0 = time.perf_counter()
    ct.CACHE_ROOT = str(ROOT / "results" / "chip_smoke_benchdb")
    shutil.rmtree(ct.CACHE_ROOT, ignore_errors=True)
    start = kernel_launches()
    rows = bp.smoke(device=dev) + bp.smoke_frontier(device=dev)
    serving = bs.smoke(device=dev)
    rows += bq.run(quick=True, device=dev)
    zoo_launches = kernel_launches(start, KERNELS)
    print(f"paper-path launches on the zoo's benchmarks {zoo_launches}")
    if any(zoo_launches.values()):
        raise RuntimeError("the paper path's zoo benchmarks launched a "
                           "hand-written kernel")
    # the DAG gate's enc-dec LM attends through flash_attention
    start = kernel_launches()
    rows += bp.smoke_dag(device=dev)
    dag_launches = kernel_launches(start, KERNELS)
    print(f"paper-path launches on the DAG gate {dag_launches}")
    if not dag_launches["flash_attention"]:
        raise RuntimeError("the DAG gate's enc-dec LM launched no "
                           "flash_attention")
    failures = bp.failures() + bs.failures() + bq.run.failures
    for name, us, derived in rows:
        print(f"paper {name},{us:.1f},{derived}")
    print(f"paper serving: point batch {serving['point']['batch_size']} "
          f"replicas {serving['point']['replicas']}, predicted "
          f"{serving['point']['predicted_rps']} rps; poisson goodput "
          f"{serving['poisson']['goodput_rps']:.4g} rps (rel err "
          f"{serving['poisson']['rel_err']:.2%}, limit "
          f"{bs.GOODPUT_TOLERANCE:.0%}); bursty shed "
          f"{serving['bursty']['shed']}; replan swaps "
          f"{serving['replan']['swaps']}")
    print(f"paper phase: {time.perf_counter() - t0:.1f} s of wall time; "
          f"gate failures {failures}")
    if failures:
        raise RuntimeError(f"the paper's benchmarks failed their gates: "
                           f"{failures}")


def analysis_phase(dev) -> None:
    """The analysis passes on the card: ``python -m repro_torch.analysis``
    with ``--strict`` over every target, with the card's shared-memory
    limit and the demo graph's kernel-bearing blocks captured in CUDA
    graphs; each kernel's footprint at each path shape beside the limit,
    with the candidates the shared-memory and tiling analyses prune; the
    demo graph's blocks captured once more, apart; then
    ``bench_autotune_torch``'s sweep with its two pruning gates and
    ``--verify-smem``.  Each kernel must launch during the phase (the
    counts are set to 0 before it); any failure raises."""
    from benchmarks import bench_autotune_torch as ba

    from repro_torch.analysis import cli, fx_lint
    from repro_torch.analysis.kernel_smem import (kernel_smem_bytes,
                                                  lint_candidates)
    from repro_torch.analysis.tiling import misaligned_candidates
    from repro_torch.core.graph import fuse_blocks
    from repro_torch.kernels.substrate import (DEFAULT_CANDIDATES,
                                               card_smem_limit)

    t0 = time.perf_counter()
    start = kernel_launches()
    limit = card_smem_limit(dev)
    rc = cli.main(["--device", str(dev), "--strict", "--allow", "SCN309",
                   "--allow", "SCN310", "kernels", "graphs", "tiling", "jaxpr", "cost",
                   str(ROOT / "examples" / "dbs" / "edge_cloud_db.json"),
                   str(ROOT / "examples" / "plans" /
                       "edge_cloud_feasible.json")])
    print(f"analysis: scission-lint --strict exit code {rc} with the card's "
          f"limit of {limit} B per block, in "
          f"{time.perf_counter() - t0:.1f} s")
    if rc:
        raise RuntimeError("scission-lint --strict failed on the card")
    for kernel, cands in sorted(DEFAULT_CANDIDATES.items()):
        for path, args, options in cli.KERNEL_SHAPES[kernel]:
            sizes = {json.dumps(p, sort_keys=True): kernel_smem_bytes(
                kernel, p, args, options) for p in cands}
            kept, pruned, _ = lint_candidates(kernel, cands, args, limit,
                                              options)
            tiled = misaligned_candidates(kernel, kept, args, options)
            print(f"analysis footprint {kernel} at {path} "
                  f"{tuple(args[0].shape)}: {sizes} B vs {limit} B; pruned "
                  f"{sorted(pruned)}; tile-pruned {tiled}")
    demo = fuse_blocks(cli.demo_kernel_graph())
    diags = fx_lint.lint_blocks(demo, device=dev)
    print(f"analysis: the demo graph's {len(demo)} kernel-bearing blocks "
          f"captured in CUDA graphs on the card, diagnostics "
          f"{[d.render() for d in diags]}")
    if diags:
        raise RuntimeError("the FX lint flagged the demo graph on the card")
    rows = ba.run(quick=True, device=dev)
    for name, us, derived in rows:
        print(f"analysis {name},{us:.1f},{derived}")
    if ba.run.failures:
        raise RuntimeError(f"bench_autotune_torch's gates failed: "
                           f"{ba.run.failures}")
    vv = ba.verify_smem(dev)
    for e in vv["kernels"]:
        for c in e["candidates"]:
            print(f"analysis verify-smem {e['kernel']} at {e['path']} "
                  f"{c['params']}: {c['smem_bytes']} B dynamic + "
                  f"{e['static_smem']} B static; admitted {c['admitted']}, "
                  f"launched {c['launched']}"
                  + (f", refused: {c['refusal']}" if c["refusal"] else "")
                  + ("" if c["agrees"] else "  <-- DISAGREES"))
    if not vv["ok"]:
        raise RuntimeError("--verify-smem: a launch disagreed with the "
                           "shared-memory analysis")
    counts = kernel_launches(start, KERNELS)
    print(f"analysis-phase launches {counts}")
    require_launches(counts)
    print(f"analysis phase: {time.perf_counter() - t0:.1f} s of wall time")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None,
                    help="directory for the BenchmarkDBs and tuner JSON")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))

    from repro_torch.core import Link, NetworkModel, Resource
    from repro_torch.core.resources import CLOUD_VM, EDGE_BOX_1
    from repro_torch.kernels import _build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    print(smi[0])
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    peak_flops, peak_bw = peaks(name)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {name}; "
          f"peaks {peak_flops / 1e12:.0f} TFLOP/s bf16, "
          f"{peak_bw / 1e12:.2f} TB/s")

    # -- build ----------------------------------------------------------
    t0 = time.perf_counter()
    out_dir = _build.build_all()
    print(f"built kernels in {out_dir.relative_to(ROOT)} in "
          f"{time.perf_counter() - t0:.1f} s")
    for src in _build.SOURCES:
        rep = _build.ptxas_report(src).values()
        spills = [v["spill_stores"] for v in rep if v["spill_stores"]]
        print(f"  ptxas {src}: {len(rep)} kernels, registers "
              f"{min(v['registers'] for v in rep)}-"
              f"{max(v['registers'] for v in rep)}; spill stores in "
              f"{len(spills)} (up to {max(spills, default=0)} B)")

    resources = [Resource("edge1", "edge", EDGE_BOX_1, speed_factor=2.0),
                 Resource("cloud", "cloud", CLOUD_VM, speed_factor=1.0)]
    net = NetworkModel(default=Link("wired", 0.005, 1e8))
    launches: dict[str, int] = {}
    t0 = time.perf_counter()
    kernels, prefill_db = prefill_phase(dev, resources, net, args.out,
                                        launches)
    torch.cuda.empty_cache()          # the prefill tensors are gone
    print(f"prefill phase: {time.perf_counter() - t0:.1f} s of wall time")
    t0 = time.perf_counter()
    kernels += decode_phase(dev, resources, net, args.out, launches)
    torch.cuda.empty_cache()
    print(f"decode phase: {time.perf_counter() - t0:.1f} s of wall time")
    kernels += lm_phase(dev, resources, net, args.out, prefill_db)
    gc.collect()
    torch.cuda.empty_cache()
    train, train_rows = train_phase(dev, smi[0], peak_flops, args.out)
    kernels += train_rows
    for r in kernels:
        if r["name"] in train:
            r["train"] = train[r["name"]]
    mesh, mesh_rows = mesh_phase(dev, smi[0], args.out)
    kernels += mesh_rows
    for r in kernels:
        if r["name"] in mesh:
            r["mesh"] = mesh[r["name"]]

    # the zoo path runs none of the hand-written kernels
    start = kernel_launches()
    sys.path.insert(0, str(ROOT))
    fp32 = next(v for k, v in FP32_PEAKS.items() if k in name)
    t0 = time.perf_counter()
    zoo_phase(dev, args.out, fp32, peak_bw)
    print(f"zoo phase: {time.perf_counter() - t0:.1f} s of wall time")
    zoo_launches = kernel_launches(start, KERNELS)
    print(f"zoo-path launches {zoo_launches}")
    if any(zoo_launches.values()):
        raise RuntimeError("the zoo path launched a hand-written kernel")
    torch.cuda.empty_cache()

    # the paper's benchmarks: the zoo's launch no hand-written kernel, the
    # DAG gate's enc-dec LM launches flash_attention (checked inside)
    paper_phase(dev)
    torch.cuda.empty_cache()

    # the analysis passes on the card, after the paths they reason about
    analysis_phase(dev)
    torch.cuda.empty_cache()

    report = []
    for r in kernels:
        t_ops = r["flops"] / peak_flops * 1e3
        t_bytes = r["nbytes"] / peak_bw * 1e3
        bound_ms = max(t_ops, t_bytes)
        bound_by = "operations" if t_ops >= t_bytes else "bytes"
        ms, lib_ms, kname = r["ms"], r["lib_ms"], r["name"]
        n_launch = r.get("launches", launches.get(kname))
        of = r.get("launches_of")
        where = f"of {of}" if of else "on the main path"
        lib = f"{lib_ms:.4f} ms" if lib_ms is not None else "n/a"
        build = "".join(f"; {k} {v}" for k, v in r.get("build", {}).items())
        print(f"kernel {kname} ({r['design']}{build}): {r['shapes']}; max "
              f"abs err {r['err']:.4g} ({r['tol']}); {ms:.4f} ms of device "
              f"time ({r['call_ms']:.4f} ms per call, launch included; host work {r['host_ms']:.4f} "
              f"ms per call) vs plain {r['plain_ms']:.4f} "
              f"ms, library {lib}; bound {bound_ms:.4f} ms by {bound_by} "
              f"({r['flops'] / 1e9:.2f} GFLOP, {r['nbytes'] / 1e6:.2f} MB); "
              f"{n_launch} launches {where}; "
              f"{r['flops'] / ms / 1e9:.2f} TFLOP/s, "
              f"{r['nbytes'] / ms / 1e9:.3f} TB/s achieved")
        report.append({
            "name": kname, "route": "cuda", "design": r["design"],
            "source": "src/repro_torch/kernels/csrc/"
                      f"{r['tpu'].split('.')[0]}.cu",
            "replaces": r.get("replaces", f"src/repro/kernels/{r['tpu']}"),
            "launches": n_launch, "max_abs_err": r["err"], "ms": ms,
            "call_ms": r["call_ms"],
            "host_ms": r["host_ms"], "plain_ms": r["plain_ms"],
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms,
            **({"launches_of": of} if of else {}),
            **({"launches_train": r["train"]} if "train" in r else {}),
            **({"launches_mesh": r["mesh"]} if "mesh" in r else {}),
            **({"launches_split": r["launches_split"]}
               if "launches_split" in r else {}),
            **({"tick": r["tick"]} if "tick" in r else {}),
            **r.get("build", {})})
    torch.cuda.synchronize()

    print(json.dumps({"kernels": report}))
    # the port runs on cuda:0 alone: the one card this run used
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": 1}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
