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
HMMA instructions in the SASS (there must be some); the flash and decode
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
tokens, 16 new); and the reduced gemma2 of
``examples/partition_and_serve_torch.py``, whose local layers decode with
a window.  Each is driven with the launch counts set to 0 and must launch
every kernel it runs.  Each engine's requests are then held by a
teacher-forced check: prompt and generated tokens through ``forward`` with
the kernels and with their plain versions (the module attributes the
layers call, patched), logits within ``LM_TOL`` (relative norm), and every
engine token equal to the plain argmax wherever the plain top-2 margin
exceeds ``LM_MARGIN`` times the largest logit difference.  Four more
decode_attention rows follow, under the sizes the paths adopted: one at
each engine's widths and the lengths of its heaviest decode step, the one
that read the most cache rows (granite-8b; zamba2's head_dim 80; the
example's head_dim 32 with its window of 16), and one at gemma2-9b's full
widths with its window of 4096, which no path runs and whose launches are
the example's, labelled so.

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
engine.  Six rows follow: ``ssd_scan`` at the mLSTM's widths,
``flash_attention`` without a mask at whisper's encoder (beside SDPA),
``decode_attention`` over whisper's cross cache and its self cache, and at
the qwen2-moe engine's and internvl2's widths (each beside masked SDPA),
at the lengths of the path's heaviest decode step.
The ``paper`` phase also runs ``bench_partitions_torch``'s DAG gate, whose
enc-dec LM must launch flash_attention (the zoo's benchmarks none).

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


def kernel_split(fn, calls: int = 10) -> dict:
    """Device time per call (ms) of each CUDA kernel ``fn()`` launches, by
    kernel name, from ``torch.profiler`` over ``calls`` calls; empty where
    the profiler sees no device time."""
    import re
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out: dict[str, float] = {}
    for ev in prof.key_averages():
        t = getattr(ev, "device_time_total", 0) or 0
        name = re.search(r"(\w+)[<(]", ev.key)   # the kernel's own name
        if t and name:
            out[name.group(1)] = out.get(name.group(1), 0.0) + t / calls / 1e3
    return out


def mma_build(what: str, ptxas: list, sass: list) -> dict:
    """Registers, spill stores and the fewest HMMA of the bf16 tensor-core
    instances a path runs (their ``-Xptxas -v`` entries and SASS opcode
    counts); raises if an instance has no HMMA."""
    hmma = min(ops["HMMA"] for ops in sass)
    if not hmma:
        raise RuntimeError(f"{what}: a bf16 instance on the main path has no "
                           "HMMA instruction in its SASS")
    return dict(registers=max(e["registers"] for e in ptxas),
                spill_stores=max(e["spill_stores"] for e in ptxas),
                hmma=hmma)


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

    fa_mod.launches = 0
    ssd_mod.launches = 0
    outputs, db = scission_loop("prefill", graph, x, resources, net, dev,
                                out_dir)
    launches.update({"flash_attention": fa_mod.launches,
                     "ssd_scan": ssd_mod.launches})
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
    split = kernel_split(call)
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

    da_mod.launches = 0
    outputs, _ = scission_loop("decode", graph, q, resources, net, dev,
                               out_dir)
    launches["decode_attention"] = da_mod.launches
    require_launches({"decode_attention": da_mod.launches})
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
    split = kernel_split(call)
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
# teacher-forced check, decided before the first run on the card: the
# kernels' logits against the plain versions' by relative norm error
# (tests/test_kernels.py:18-19), and each engine token equal to the plain
# argmax wherever the plain top-2 margin exceeds LM_MARGIN x the request's
# largest logit difference between the two runs
LM_TOL = 3e-2
LM_MARGIN = 2.0


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


def _plain_kernels():
    """The model's kernel entry points replaced by their plain versions
    (``kernels/ref.py``), as a context manager: the module attributes the
    layers call are patched, and restored on exit."""
    import contextlib

    from repro_torch.kernels import ref
    from repro_torch.models import encdec
    from repro_torch.models import layers as L
    from repro_torch.models import ssm

    @contextlib.contextmanager
    def patched():
        saved = (L.flash_attention, L.decode_attention, ssm.ssd_scan,
                 encdec.flash_attention, encdec.decode_attention)
        L.flash_attention = encdec.flash_attention = lambda q, k, v, *, \
            causal=True, window=None, softcap=None, block_q=None, \
            block_k=None: ref.flash_attention_ref(
                q, k, v, causal=causal, window=window, softcap=softcap)
        L.decode_attention = encdec.decode_attention = lambda q, k, v, \
            lengths, *, softcap=None, window=None, block_k=None: \
            ref.decode_attention_ref(q, k, v, lengths, softcap=softcap,
                                     window=window)
        ssm.ssd_scan = lambda x, la, b, c, *, chunk: ref.ssd_ref(
            x, la, b, c, chunk=chunk)
        try:
            yield
        finally:
            (L.flash_attention, L.decode_attention, ssm.ssd_scan,
             encdec.flash_attention, encdec.decode_attention) = saved

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
                   inputs=None, prefix: int = 0) -> dict:
    """Each finished request's prompt and generated tokens (the last one
    dropped) through ``forward`` twice, with the kernels and with their
    plain versions; ``pad_to`` pads the sequence with zeros to a multiple
    (Mamba-2's chunk), which causal layers never show the real positions.
    ``inputs(r)`` gives a request's other ``forward`` arguments (frames,
    patch embeddings), and ``prefix`` the positions they put before the
    tokens.  Raises unless the logits agree within ``LM_TOL`` (relative
    norm, every position) and the engine's tokens equal the plain argmax
    at every held position (``_hold``, ``LM_MARGIN``); returns the counts
    and worst errors."""
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
        holds.append(_hold(label, r.rid, got, want, r.tokens, LM_TOL,
                           LM_MARGIN, gen=slice(len(r.prompt) - 1, n)))
    return _holds(label, "teacher-forced", holds, LM_TOL, LM_MARGIN)


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


def kernel_launches() -> dict:
    """The wrappers' launch counts now, the SSD's wide route's apart."""
    from repro_torch.kernels import decode_attention as da_mod
    from repro_torch.kernels import flash_attention as fa_mod
    from repro_torch.kernels import ssd_scan as ssd_mod
    return {"flash_attention": fa_mod.launches,
            "decode_attention": da_mod.launches,
            "ssd_scan": ssd_mod.launches,
            "ssd_scan wide route": ssd_mod.wide_launches}


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
    in_run = {k: n - before[k] for k, n in kernel_launches().items()}
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
    from repro_torch.kernels import decode_attention as da_mod
    from repro_torch.kernels import flash_attention as fa_mod
    from repro_torch.kernels import ssd_scan as ssd_mod
    from repro_torch.models.graph_adapter import lm_to_graph
    from repro_torch.serving import Request

    label = "lm granite-8b"
    model, params = lm_model("granite-8b", dev, cfg)
    vocab = model.cfg.vocab
    fa_mod.launches = da_mod.launches = ssd_mod.launches = 0
    graph = lm_to_graph(model, params, batch=1, seq_len=LM_GRAPH_SEQ)
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    tokens = torch.randint(0, vocab, (1, LM_GRAPH_SEQ), generator=gen,
                           device=dev, dtype=torch.int32)
    print(f"{label} graph: {graph.n_layers} nodes, "
          f"{len(graph.partition_points())} partition points, sequence "
          f"{LM_GRAPH_SEQ}")
    outputs, db = scission_loop("lm-granite", graph, tokens, resources, net,
                                dev, out_dir)
    require_launches({"flash_attention": fa_mod.launches})
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
    launches = {"flash_attention": fa_mod.launches,
                "decode_attention": da_mod.launches}
    require_launches(launches)
    done = run.pop("done")
    check = teacher_forced(label, model, params, done)
    del model, params
    torch.cuda.empty_cache()
    return dict(launches=launches, blocks=blocks, engine=run, check=check,
                lengths=run.pop("lengths"))


def lm_zamba(dev, cfg=None) -> dict:
    """zamba2-2.7b: the engine alone (exact admission); returns the path's
    launches, numbers and the lengths of its heaviest decode step."""
    import numpy as np
    import torch
    from repro_torch.kernels import decode_attention as da_mod
    from repro_torch.kernels import flash_attention as fa_mod
    from repro_torch.kernels import ssd_scan as ssd_mod
    from repro_torch.serving import Request

    label = "lm zamba2-2.7b"
    model, params = lm_model("zamba2-2.7b", dev, cfg)
    e = ZAMBA_ENGINE
    rng = np.random.default_rng(SEED + 1)
    requests = [Request(rid=i, prompt=rng.integers(
        0, model.cfg.vocab, int(rng.choice(e["prompts"]))),
        max_new_tokens=e["new"]) for i in range(e["requests"])]
    fa_mod.launches = da_mod.launches = ssd_mod.launches = 0
    run = serve(label, model, params, requests, e["width"], e["max_len"])
    launches = {"flash_attention": fa_mod.launches,
                "decode_attention": da_mod.launches,
                "ssd_scan": ssd_mod.launches}
    require_launches(launches)
    done = run.pop("done")
    if run["path"] != "exact":
        raise RuntimeError(f"{label}: admission was not the exact path")
    check = teacher_forced(label, model, params, done,
                           pad_to=model.cfg.ssm_chunk)
    del model, params
    torch.cuda.empty_cache()
    return dict(launches=launches, engine=run, check=check,
                lengths=run.pop("lengths"))


def lm_example(dev) -> dict:
    """examples/partition_and_serve_torch.py's four steps on its reduced
    gemma2 (local layers with a window of 16, outgrown by its sequences),
    then the teacher-forced check of its engine's tokens: returns the
    path's launches, the model's widths and the lengths of the engine's
    heaviest decode step."""
    import importlib.util

    from repro_torch.kernels import decode_attention as da_mod
    from repro_torch.kernels import flash_attention as fa_mod
    from repro_torch.kernels import ssd_scan as ssd_mod

    spec = importlib.util.spec_from_file_location(
        "partition_and_serve_torch",
        ROOT / "examples" / "partition_and_serve_torch.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    fa_mod.launches = da_mod.launches = ssd_mod.launches = 0
    cwd = os.getcwd()
    os.chdir(ROOT)
    try:
        with decode_lengths() as steps:
            model, params, eng, done = example.main(["--device", str(dev)])
    finally:
        os.chdir(cwd)
    launches = {"flash_attention": fa_mod.launches,
                "decode_attention": da_mod.launches}
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
    from repro_torch.kernels import decode_attention as da_mod
    from repro_torch.kernels import flash_attention as fa_mod
    from repro_torch.kernels import ssd_scan as ssd_mod
    from repro_torch.models.graph_adapter import moe_to_graph

    label = "lm qwen2-moe-a2.7b"
    model, params = lm_model("qwen2-moe-a2.7b", dev, cfg)
    c = model.cfg
    fa_mod.launches = da_mod.launches = ssd_mod.launches = 0
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
    launches = {"flash_attention": fa_mod.launches,
                "decode_attention": da_mod.launches}
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
    from repro_torch.kernels import decode_attention as da_mod
    from repro_torch.kernels import flash_attention as fa_mod
    from repro_torch.kernels import ssd_scan as ssd_mod
    from repro_torch.models.graph_adapter import xlstm_to_graph

    label = "lm xlstm-125m"
    model, params = lm_model("xlstm-125m", dev, cfg)
    c = model.cfg
    fa_mod.launches = da_mod.launches = ssd_mod.launches = 0
    ssd_mod.wide_launches = 0
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
    dag = {"ssd_scan (DAG loop)": ssd_mod.launches,
           "ssd_scan wide route (DAG loop)": ssd_mod.wide_launches}
    require_launches(dag)
    requests = lambda: _requests(c.vocab, XLSTM_ENGINE, SEED + 3)  # noqa
    e = XLSTM_ENGINE
    t0 = time.perf_counter()
    ssd_mod.launches = ssd_mod.wide_launches = 0
    run = serve(label, model, params, requests(), e["width"], e["max_len"])
    if run["path"] != "exact":
        raise RuntimeError(f"{label}: admission was not the exact path")
    launches = {"ssd_scan (engine)": ssd_mod.launches,
                "ssd_scan wide route (engine)": ssd_mod.wide_launches,
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
    that each call adds the launches it made, read from the wrapper's own
    count, to ``counts[key_of(args, kwargs)]``; returns the original."""
    import importlib
    real = getattr(module, name)
    kernel = importlib.import_module(real.__module__)

    def counted(*args, **kwargs):
        before = kernel.launches
        out = real(*args, **kwargs)
        counts[key_of(args, kwargs)] += kernel.launches - before
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
    from repro_torch.kernels import decode_attention as da_mod
    from repro_torch.kernels import flash_attention as fa_mod
    from repro_torch.kernels import ssd_scan as ssd_mod
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
    fa_mod.launches = da_mod.launches = ssd_mod.launches = 0
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
    launches = {"flash_attention": fa_mod.launches,
                "decode_attention": da_mod.launches, **dict(routes)}
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
    from repro_torch.kernels import decode_attention as da_mod
    from repro_torch.kernels import flash_attention as fa_mod
    from repro_torch.kernels import ssd_scan as ssd_mod
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
    fa_mod.launches = da_mod.launches = ssd_mod.launches = 0
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
    launches = {"flash_attention": fa_mod.launches,
                "decode_attention": da_mod.launches}
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


def ssd_mlstm_row(dev, launches, by_stage=None) -> dict:
    """The ssd_scan row at xlstm-125m's mLSTM widths: x = v i, b = k /
    sqrt(384), c = q, (1, 2048, 4, 384) bf16, log_a = log sigmoid(f) in
    fp32, chunk 128 (the wide route), held against the plain version and
    timed beside it; ``launches`` are the xLSTM path's wide-route ones,
    ``by_stage`` the same by stage."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import ssd_scan as ssd_mod

    Bn, Sn, Hn, P, chunk = 1, XLSTM_GRAPH_SEQ, 4, 384, 128
    gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    shape = (Bn, Sn, Hn, P)
    v, k, q = (torch.randn(shape, generator=gen, device=dev)
               for _ in range(3))
    i_g, f_g = (torch.randn(shape[:3], generator=gen, device=dev)
                for _ in range(2))
    x = (v * torch.sigmoid(i_g)[..., None]).to(torch.bfloat16)
    b = (k / math.sqrt(P)).to(torch.bfloat16)
    c = q.to(torch.bfloat16)
    la = F.logsigmoid(f_g)
    y, fin = ssd_mod.ssd_scan(x, la, b, c, chunk=chunk)
    args = (x.float(), la, b.float(), c.float())
    y_ref, fin_ref = ref.ssd_ref(*args, chunk=chunk)
    err = check_close("ssd_scan_mlstm_hd384 y vs plain", y, y_ref)
    fin_err = check_close("ssd_scan_mlstm_hd384 final state vs plain", fin,
                          fin_ref)

    def call():
        return ssd_mod.ssd_scan(x, la, b, c, chunk=chunk)
    ms, call_ms = time_ms(call), time_ms(call, hold=False)
    host = host_ms(call)
    split = kernel_split(call)
    plain_ms = time_ms(lambda: ref.ssd_ref(*args, chunk=chunk), runs=10)
    nc = -(-Sn // chunk)
    tri = chunk * (chunk + 1) // 2
    flops = 2.0 * Bn * Hn * nc * (tri * P + tri * P + 2 * chunk * P * P)
    ws_bytes = ssd_mod.workspace_bytes({"chunk": chunk}, (x.shape, b.shape),
                                       x.dtype)
    passes = {name: ssd_mod.mma_passes(report("ssd_scan"), P, la.dtype, P)
              for name, report in (("ptxas", _build.ptxas_report),
                                   ("sass", _build.sass_opcodes))}
    build = mma_build("ssd_scan_mlstm_hd384",
                      sum(passes["ptxas"].values(), []),
                      sum(passes["sass"].values(), []))
    print("ssd_scan_mlstm_hd384 device time per pass (torch.profiler): " + (
        ", ".join(f"{k} {v:.4f} ms" for k, v in split.items())
        or "not measured"))
    print("ssd_scan_mlstm_hd384 bf16 passes: " + "; ".join(
        f"{name}: registers {max(e['registers'] for e in es)}, spill stores "
        f"{max(e['spill_stores'] for e in es)}, HMMA "
        f"{min(o['HMMA'] for o in passes['sass'][name])}"
        for name, es in sorted(passes["ptxas"].items())))
    return dict(
        name="ssd_scan_mlstm_hd384", tpu="ssd_scan.py:93",
        design="mma.sync bf16, chunk-parallel 3-pass, wide route (64 x 128 "
               "state tiles; N streamed in slabs of 64 over 128-wide P "
               "tiles)",
        build=dict(**build, workspace_bytes=ws_bytes),
        shapes=f"x, b, c {shape} bf16 (x = v sigmoid(i), b = k / sqrt(384), "
               f"c = q), log_a fp32, chunk={chunk}; final-state max abs err "
               f"{fin_err:.4g}; workspace {ws_bytes} B",
        err=err, tol=f"tol {TOL} abs + {TOL} rel", ms=ms, call_ms=call_ms,
        host_ms=host, plain_ms=plain_ms, flops=flops,
        nbytes=moved_bytes(x, la, b, c, y, fin), lib_ms=None,
        launches=launches, **({"launches_split": by_stage} if by_stage else {}))


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
    (the exact engine), the example's reduced gemma2, qwen2-moe-a2.7b (DAG
    loop over its layer 0 MoE, the bucketed engine), xlstm-125m (DAG loop,
    the exact engine), whisper-medium (prefill and decode over frames, DAG
    loop) and internvl2-76b's backbone cut in depth; then a
    decode_attention row at each engine's widths and the lengths of its
    heaviest decode step (the example's with its window), one at
    gemma2-9b's full widths with its window, which no path runs, and the
    rows of the new routes: ssd_scan at the mLSTM's 384-wide heads, flash
    without a mask and decode over whisper's cross cache; then decode rows
    at the other families' widths and the lengths of their heaviest step
    (whisper's self-attention, the qwen2-moe engine, internvl2).  The rows
    run under the adopted sizes, as the paths did.  Returns those rows."""
    import time

    import torch
    from repro_torch.kernels import substrate
    from repro_torch.models import get_config

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
    substrate.clear_tuned_params()
    print(f"lm decode rows: {time.perf_counter() - t1:.1f} s of wall time")
    print(f"lm phase: {time.perf_counter() - t0:.1f} s of wall time")
    return rows


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
    ``torch.profiler``; 0.0 where the profiler sees no device time."""
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
               if e.device_type == DeviceType.CUDA) / 1e3


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

    from repro_torch.kernels import decode_attention as da_mod
    from repro_torch.kernels import flash_attention as fa_mod
    from repro_torch.kernels import ssd_scan as ssd_mod

    def counts():
        return {"flash_attention": fa_mod.launches,
                "ssd_scan": ssd_mod.launches,
                "decode_attention": da_mod.launches}

    t0 = time.perf_counter()
    ct.CACHE_ROOT = str(ROOT / "results" / "chip_smoke_benchdb")
    shutil.rmtree(ct.CACHE_ROOT, ignore_errors=True)
    fa_mod.launches = ssd_mod.launches = da_mod.launches = 0
    rows = bp.smoke(device=dev) + bp.smoke_frontier(device=dev)
    serving = bs.smoke(device=dev)
    rows += bq.run(quick=True, device=dev)
    zoo_launches = counts()
    print(f"paper-path launches on the zoo's benchmarks {zoo_launches}")
    if any(zoo_launches.values()):
        raise RuntimeError("the paper path's zoo benchmarks launched a "
                           "hand-written kernel")
    # the DAG gate's enc-dec LM attends through flash_attention
    fa_mod.launches = ssd_mod.launches = da_mod.launches = 0
    rows += bp.smoke_dag(device=dev)
    dag_launches = counts()
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
    torch.cuda.empty_cache()

    # the zoo path runs none of the hand-written kernels
    from repro_torch.kernels import decode_attention as da_mod
    from repro_torch.kernels import flash_attention as fa_mod
    from repro_torch.kernels import ssd_scan as ssd_mod
    fa_mod.launches = ssd_mod.launches = da_mod.launches = 0
    sys.path.insert(0, str(ROOT))
    fp32 = next(v for k, v in FP32_PEAKS.items() if k in name)
    t0 = time.perf_counter()
    zoo_phase(dev, args.out, fp32, peak_bw)
    print(f"zoo phase: {time.perf_counter() - t0:.1f} s of wall time")
    zoo_launches = {"flash_attention": fa_mod.launches,
                    "ssd_scan": ssd_mod.launches,
                    "decode_attention": da_mod.launches}
    print(f"zoo-path launches {zoo_launches}")
    if any(zoo_launches.values()):
        raise RuntimeError("the zoo path launched a hand-written kernel")
    torch.cuda.empty_cache()

    # the paper's benchmarks: the zoo's launch no hand-written kernel, the
    # DAG gate's enc-dec LM launches flash_attention (checked inside)
    paper_phase(dev)

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
            "replaces": f"src/repro/kernels/{r['tpu']}",
            "launches": n_launch, "max_abs_err": r["err"], "ms": ms,
            "call_ms": r["call_ms"],
            "host_ms": r["host_ms"], "plain_ms": r["plain_ms"],
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms,
            **({"launches_of": of} if of else {}),
            **({"launches_split": r["launches_split"]}
               if "launches_split" in r else {}),
            **r.get("build", {})})
    torch.cuda.synchronize()

    print(json.dumps({"kernels": report}))
    # the port runs on cuda:0 alone: the one card this run used
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": 1}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
