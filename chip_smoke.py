#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Drives the port's main path, Scission's loop over the kernel-bearing graph
(flash attention -> dense -> SSD scan -> dense) at zamba2-2.7b widths
(one sequence of 4096 tokens, 32 heads of head_dim 80, SSM state 64, bf16,
seeded random weights):

1. build the hand-written CUDA kernels from ``src/repro_torch/kernels/csrc``;
2. autotune the kernels' block sizes and benchmark every block on two
   emulated resources into a ``BenchmarkDB``;
3. query the best partition (wired link, source ``edge1``);
4. run it, and the best two-stage partition, with ``PipelineExecutor``.

Every kernel's launch count is read right after that run and must be > 0.
Then the partitioned outputs are held against a whole-graph run with the
same kernels (exactly equal) and against the whole graph with each kernel
replaced by its plain PyTorch version with TF32 off and bf16 activations
between layers, as the graph has them (bf16 tolerance, 3e-2 absolute plus
3e-2 relative); the distance to the all-fp32 plain graph is printed.
Each kernel is held against its plain version at the main path's shapes
and timed with CUDA events beside its plain version, its bound from the
card's peak figures and, for attention,
``scaled_dot_product_attention`` as a yardstick.

Usage: ``python3 chip_smoke.py [--out DIR]`` from the repo root; ``--out``
also writes the BenchmarkDB and autotuner records there.  The last line of
standard output is ``{"ok": true, "device": {...}}``; any failure exits
non-zero without it.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0
B, S, H, HD, STATE = 1, 4096, 32, 80, 64     # zamba2-2.7b widths
TOL = 3e-2                                   # bf16 (tests/test_kernels.py)

# dense peaks of the card (NVIDIA data sheets): bf16 tensor FLOP/s, bytes/s
PEAKS = {"H100 PCIe": (756e12, 2.0e12), "H100 NVL": (835e12, 3.9e12),
         "H100": (989e12, 3.35e12)}


def peaks(name: str) -> tuple[float, float]:
    for key, val in PEAKS.items():
        if key in name:
            return val
    raise RuntimeError(f"no peak figures for {name!r}")


def time_ms(fn, runs: int = 20) -> float:
    """Median of ``runs`` CUDA-event timings of ``fn()`` after a warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def check_close(what: str, got, want) -> float:
    """Max abs error of ``got`` against ``want``; raises unless they agree
    within ``TOL`` absolute plus ``TOL`` relative."""
    import torch
    got, want = got.float(), want.float()
    torch.testing.assert_close(got, want, rtol=TOL, atol=TOL,
                               msg=lambda m: f"{what}: {m}")
    return (got - want).abs().max().item()


def moved_bytes(*tensors) -> float:
    """Bytes a call must move when each input is read once and each output
    written once: tensors that share storage (``q = k = v``, or ``b = c``
    as views of ``x``) are counted once, at the widest of their spans."""
    spans: dict[int, int] = {}
    for t in tensors:
        key = t.untyped_storage().data_ptr()
        spans[key] = max(spans.get(key, 0), t.numel() * t.element_size())
    return float(sum(spans.values()))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None,
                    help="directory for the BenchmarkDB and tuner JSON")
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

    import torch.nn.functional as F

    from repro_torch.core import (Link, NetworkModel, Query, QueryEngine,
                                  Resource, TensorSpec, TimingProvider,
                                  benchmark_model, fuse_blocks)
    from repro_torch.core.resources import CLOUD_VM, EDGE_BOX_1
    from repro_torch.kernel_graph import kernel_graph
    from repro_torch.kernels import KernelAutotuner, _build, ref
    from repro_torch.kernels import flash_attention as fa_mod
    from repro_torch.kernels import ssd_scan as ssd_mod
    from repro_torch.runtime import PipelineExecutor

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
    out_dir = _build.build_all()
    print(f"built kernels in {out_dir.relative_to(ROOT)}")
    for src in _build.SOURCES:
        for line in _build.build_log(src).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {src}: {line.strip()}")

    # -- the graph at zamba2-2.7b widths ----------------------------------
    gen = torch.Generator().manual_seed(SEED)
    weights = {n: (torch.randn(HD, HD, generator=gen) * 0.05)
               .to(dev, torch.bfloat16) for n in ("mlp0", "mlp1")}
    x = torch.randn(B, S, H, HD, generator=gen).to(dev, torch.bfloat16)
    spec = TensorSpec((B, S, H, HD), torch.bfloat16)
    graph = kernel_graph(spec, weights, state_dim=STATE, device=dev)
    resources = [Resource("edge1", "edge", EDGE_BOX_1, speed_factor=2.0),
                 Resource("cloud", "cloud", CLOUD_VM, speed_factor=1.0)]
    net = NetworkModel(default=Link("wired", 0.005, 1e8))

    # -- main path: autotune -> BenchmarkDB -> query -> partitioned run ---
    fa_mod.launches = 0
    ssd_mod.launches = 0
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
    for label, cfg in runs.items():
        pipe = PipelineExecutor(graph, cfg, net, source="edge1", device=dev)
        pipe.run(x)                     # warm-up: the timed run is the second
        y, timings = pipe.run(x, collect_timing=True)
        outputs[label] = (cfg, y, timings)
    launches = {"flash_attention": fa_mod.launches,
                "ssd_scan": ssd_mod.launches}

    for rec in tuner.records.values():
        trials = {k: round(v * 1e3, 3) for k, v in rec.trials.items()}
        pruned = {k: int(v) for k, v in rec.pruned.items()}
        print(f"tune {rec.kernel} @{rec.resource} {rec.shape_key}: "
              f"winner {rec.params} ({rec.time_s * 1e3:.3f} ms, default "
              f"{rec.default_params} {rec.default_time_s * 1e3:.3f} ms); "
              f"trials ms {trials}; pruned over {int(rec.vmem_limit)} B "
              f"{pruned}")
    for res in resources:
        print(f"db {res.name}: " + ", ".join(
            f"block {r.block} {r.mean_time_s * 1e3:.3f} ms"
            for r in db.records[res.name]))
    print(f"query ({result.strategy}, {result.query_time_s * 1e3:.1f} ms): "
          f"best {best.describe()}")
    for label, (cfg, y, timings) in outputs.items():
        print(f"pipeline {label} {cfg.describe()}: " + "; ".join(
            f"{t.resource} compute {t.compute_s * 1e3:.3f} ms, link "
            f"{t.comm_in_s * 1e3:.3f} ms, {t.bytes_in} B in"
            for t in timings))
    print(f"main-path launches {launches}")
    for k, n in launches.items():
        if n <= 0:
            raise RuntimeError(f"{k} was never launched on the main path")

    if args.out:
        os.makedirs(args.out, exist_ok=True)
        Path(args.out, "chip_smoke_db.json").write_text(db.to_json())
        Path(args.out, "chip_smoke_tuner.json").write_text(tuner.to_json())

    # -- whole-graph checks ----------------------------------------------
    blocks = fuse_blocks(graph)
    whole = x
    for blk in blocks:
        whole = blk.make_callable()(whole)
    for label, (_, y, _) in outputs.items():
        if y.shape != whole.shape or not torch.equal(y, whole):
            raise RuntimeError(f"{label} partitioned output differs from "
                               "the whole-graph run")

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
    graph_err = check_close("graph output vs plain", whole, plain)
    # reported, not checked: the graph rounds its activations to bf16
    # between layers, which the all-fp32 plain graph does not
    f32_diff = (whole.float() - plain_f32).abs()
    f32_out = int((f32_diff > TOL + TOL * plain_f32.abs()).sum())
    print(f"graph output {tuple(whole.shape)} {whole.dtype}: equal across "
          f"{list(outputs)} partitions and the whole-graph run; max abs err "
          f"vs the plain versions {graph_err:.4g} (tol {TOL} abs + {TOL} "
          f"rel); vs the plain versions with fp32 activations "
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
    ms = time_ms(lambda: fa_mod.flash_attention(q, q, q, causal=True,
                                                block_q=bq, block_k=bk))
    plain_ms = time_ms(lambda: ref.flash_attention_ref(qf, qf, qf,
                                                       causal=True), runs=10)
    qt = q.transpose(1, 2).contiguous()
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qt, qt, qt, is_causal=True))
    pairs = S * (S + 1) // 2                 # unmasked (q, k) pairs, causal
    flops = 4.0 * B * H * HD * pairs
    nbytes = moved_bytes(q, q, q, got)            # q = k = v read; o written
    kernels.append(("flash_attention", "flash_attention.py:122",
                    f"q=k=v {tuple(q.shape)} bf16 causal, block_q={bq} "
                    f"block_k={bk}", err, ms, plain_ms, flops, nbytes, lib_ms))

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
    ms = time_ms(lambda: ssd_mod.ssd_scan(xs, la, bc, bc, chunk=chunk))
    xsf, laf, bcf = xs.float(), la.float(), bc.float()
    plain_ms = time_ms(lambda: ref.ssd_ref(xsf, laf, bcf, bcf, chunk=chunk),
                       runs=10)
    L, nc = min(chunk, S), -(-S // min(chunk, S))
    tri = L * (L + 1) // 2                   # causal (i, j) pairs per chunk
    flops = 2.0 * B * H * nc * (tri * STATE + tri * HD + 2 * L * STATE * HD)
    nbytes = moved_bytes(xs, la, bc, bc, y, fin)
    kernels.append(("ssd_scan", "ssd_scan.py:93",
                    f"x {tuple(xs.shape)} bf16, b=c {tuple(bc.shape)}, "
                    f"chunk={chunk}; final-state max abs err {fin_err:.4g}",
                    err, ms, plain_ms, flops, nbytes, None))

    report = []
    for (kname, tpu, shapes, err, ms, plain_ms, flops, nbytes,
         lib_ms) in kernels:
        t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / peak_bw * 1e3
        bound_ms = max(t_ops, t_bytes)
        bound_by = "operations" if t_ops >= t_bytes else "bytes"
        lib = f"{lib_ms:.4f} ms" if lib_ms is not None else "n/a"
        print(f"kernel {kname}: {shapes}; max abs err {err:.4g} (tol {TOL}); "
              f"{ms:.4f} ms vs plain {plain_ms:.4f} ms, library {lib}; "
              f"bound {bound_ms:.4f} ms by {bound_by} ({flops / 1e9:.2f} "
              f"GFLOP, {nbytes / 1e6:.2f} MB); {launches[kname]} launches "
              f"on the main path; {flops / ms / 1e9:.2f} TFLOP/s achieved")
        report.append({
            "name": kname, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{kname}.cu",
            "replaces": f"src/repro/kernels/{tpu}",
            "launches": launches[kname], "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": lib_ms})
    torch.cuda.synchronize()

    print(json.dumps({"kernels": report}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
