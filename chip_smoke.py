#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Drives the port's two main paths, Scission's loop over a kernel-bearing
graph, each with seeded random weights in bf16:

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

Usage: ``python3 chip_smoke.py [--out DIR]`` from the repo root; ``--out``
also writes the BenchmarkDBs and autotuner records there.  The last line of
standard output is ``{"ok": true, "device": {...}}``; any failure exits
non-zero without it.
"""

from __future__ import annotations

import argparse
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

# dense peaks of the card (NVIDIA data sheets): bf16 tensor FLOP/s, bytes/s
PEAKS = {"H100 PCIe": (756e12, 2.0e12), "H100 NVL": (835e12, 3.9e12),
         "H100": (989e12, 3.35e12)}


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
    outputs as {label: (config, y, timings)}."""
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
    return outputs


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
    print(f"main-path launches {launches}")
    for k, n in launches.items():
        if n <= 0:
            raise RuntimeError(f"{k} was never launched on the main path")


def prefill_phase(dev, resources, net, out_dir, launches):
    """The prefill path at zamba2-2.7b widths; returns its kernel rows."""
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
    outputs = scission_loop("prefill", graph, x, resources, net, dev,
                            out_dir)
    launches.update({"flash_attention": fa_mod.launches,
                     "ssd_scan": ssd_mod.launches})
    require_launches(launches)

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
    return kernels


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
    outputs = scission_loop("decode", graph, q, resources, net, dev, out_dir)
    launches["decode_attention"] = da_mod.launches
    require_launches({"decode_attention": da_mod.launches})

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
    kernels = prefill_phase(dev, resources, net, args.out, launches)
    torch.cuda.empty_cache()          # the prefill tensors are gone
    kernels += decode_phase(dev, resources, net, args.out, launches)

    report = []
    for r in kernels:
        t_ops = r["flops"] / peak_flops * 1e3
        t_bytes = r["nbytes"] / peak_bw * 1e3
        bound_ms = max(t_ops, t_bytes)
        bound_by = "operations" if t_ops >= t_bytes else "bytes"
        ms, lib_ms, kname = r["ms"], r["lib_ms"], r["name"]
        lib = f"{lib_ms:.4f} ms" if lib_ms is not None else "n/a"
        build = "".join(f"; {k} {v}" for k, v in r.get("build", {}).items())
        print(f"kernel {kname} ({r['design']}{build}): {r['shapes']}; max "
              f"abs err {r['err']:.4g} ({r['tol']}); {ms:.4f} ms of device "
              f"time ({r['call_ms']:.4f} ms per call, launch included; host work {r['host_ms']:.4f} "
              f"ms per call) vs plain {r['plain_ms']:.4f} "
              f"ms, library {lib}; bound {bound_ms:.4f} ms by {bound_by} "
              f"({r['flops'] / 1e9:.2f} GFLOP, {r['nbytes'] / 1e6:.2f} MB); "
              f"{launches[kname]} launches on the main path; "
              f"{r['flops'] / ms / 1e9:.2f} TFLOP/s, "
              f"{r['nbytes'] / ms / 1e9:.3f} TB/s achieved")
        report.append({
            "name": kname, "route": "cuda", "design": r["design"],
            "source": f"src/repro_torch/kernels/csrc/{kname}.cu",
            "replaces": f"src/repro/kernels/{r['tpu']}",
            "launches": launches[kname], "max_abs_err": r["err"], "ms": ms,
            "call_ms": r["call_ms"],
            "host_ms": r["host_ms"], "plain_ms": r["plain_ms"],
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms,
            **r.get("build", {})})
    torch.cuda.synchronize()

    print(json.dumps({"kernels": report}))
    # the port runs on cuda:0 alone: the one card this run used
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": 1}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
