"""Kernel block-size autotuning feeding the partition decision procedure,
in the port: the counterpart of ``benchmarks/bench_autotune.py``.

    PYTHONPATH=src python -m benchmarks.bench_autotune_torch \
        [--full] [--verify-smem] [--out PATH] [--device cpu|meta]

On a small attention -> dense -> SSD -> dense graph in bf16
(``kernel_graph``):

1. sweep ``(block_q, block_k)`` / ``chunk`` candidates per (kernel, shape,
   resource): on the card each trial is the device time of CUDA-graph
   replays of the hand-written kernel;
2. benchmark the graph with the *tuned* kernels into a ``BenchmarkDB``
   (records carry ``tuned_params``);
3. run the Scission ``QueryEngine`` over that DB.

It also runs the **shared-memory pruning gate** (``analysis.kernel_smem``):
the same sweep is run again under a per-block limit set to the largest
footprint among the unconstrained winners; at least one candidate must be
pruned before timing, and the winners and their times must be bit-identical
to the unconstrained sweep's (one tuner serves both, so the constrained
sweep selects among the cached trials).  The sweep holds SSD chunk 256: at
2 heads and 1024 steps it runs 8 CTAs of 4x the intra-chunk work of chunk
64's 32, so it does not win and is the candidate the limit prunes.

The **tiling gate** (``analysis.tiling``): a sweep holding bf16 ``block_q``
48, which the bf16 flash route pads to a 64-row tile, is run with
``tile_check`` off and then on; the misaligned candidate must be pruned
before timing and the winner stay bit-identical.  A deterministic
``measure`` hook prices each candidate at its padded tile area, as the
reference's gate does, so that the padded candidate loses on its merits.

``--verify-smem`` (:func:`verify_smem`) holds the analysis against the
card at the shapes the port's paths give each kernel
(``analysis.cli.KERNEL_SHAPES``): for each kernel at its default sizes and
every candidate the analysis admits, its footprint, ptxas's static shared
memory of the instances the launch runs, and the launch (the C entry point
refuses a footprint figure other than its own); the smallest candidate the
analysis prunes must be refused by the launch, naming the same byte count
(or, refused by the tiling analysis, the same reason).

``--out`` writes the gate reports (and the ``--verify-smem`` table) as
JSON.  ``device`` selects where it all runs; off the card the kernels'
plain versions run and ``--verify-smem`` launches nothing.
"""

from __future__ import annotations

import argparse
import json
import os
import zlib

import torch

from repro_torch._device import resolve_device
from repro_torch.analysis.kernel_smem import kernel_smem_bytes
from repro_torch.core import (Link, NetworkModel, Query, QueryEngine,
                              Resource, TensorSpec, TimingProvider,
                              benchmark_model)
from repro_torch.core.graph import fuse_blocks
from repro_torch.core.resources import CLOUD_VM, EDGE_BOX_1
from repro_torch.kernel_graph import kernel_graph
from repro_torch.kernels import KernelAutotuner

DTYPE = torch.bfloat16
STATE_DIM = 64


def _shape(quick: bool) -> tuple[int, int, int]:
    """(S, H, hd) of the graph's (1, S, H, hd) activation."""
    return (1024, 2, 32) if quick else (4096, 8, 64)


def _graph(S, H, hd, dev):
    weights = {}
    for name in ("mlp0", "mlp1"):
        gen = torch.Generator().manual_seed(zlib.crc32(name.encode()))
        weights[name] = (torch.randn((hd, hd), generator=gen) * 0.05).to(
            dev, DTYPE)
    return kernel_graph(TensorSpec((1, S, H, hd), DTYPE), weights,
                        state_dim=STATE_DIM, device=dev)


def _candidates():
    return {
        "flash_attention": [{"block_q": bq, "block_k": bk}
                            for bq in (64, 128) for bk in (64, 128)],
        "ssd_scan": [{"chunk": c} for c in (32, 64, 128, 256)],
    }


def smem_gate(quick: bool = True, device: str = "cuda",
              measure=None) -> dict:
    """The shared-memory pruning gate (see the module docstring);
    ``measure`` replaces the timing (tests)."""
    dev = resolve_device(device)
    g = _graph(*_shape(quick), dev)
    blocks = fuse_blocks(g)
    tuner = KernelAutotuner(candidates=_candidates(), runs=1,
                            measure=measure, device=dev)
    for blk in blocks:                      # the card's limit (or none)
        tuner.tune_block(blk, resource="cloud")
    limit = 0
    for i, node in enumerate(g.nodes):
        if not node.kernel:
            continue
        rec = next(r for (k, _, res), r in tuner.records.items()
                   if k == node.kernel and res == "cloud")
        spec = g.nodes[g.preds[i][0]].out_spec
        limit = max(limit, kernel_smem_bytes(
            node.kernel, rec.params, [torch.empty(spec.shape, dtype=spec.dtype,
                                                  device="meta")],
            node.kernel_options))

    tuner.smem_limit = limit
    for blk in blocks:                      # constrained sweep, same tuner
        tuner.tune_block(blk, resource="edge1")

    report = {"limit_bytes": limit, "kernels": {}}
    for (kernel, shape_key, res), rec in sorted(tuner.records.items()):
        if res != "edge1":
            continue
        base = tuner.records[(kernel, shape_key, "cloud")]
        report["kernels"][kernel] = {
            "kept": len(rec.trials),
            "pruned": dict(rec.pruned),
            "winner_params": rec.params,
            "winner_time_us": rec.time_s * 1e6,
            "winner_identical": (rec.params == base.params
                                 and rec.time_s == base.time_s),
        }
    report["total_pruned"] = sum(len(k["pruned"])
                                 for k in report["kernels"].values())
    report["all_winners_identical"] = all(k["winner_identical"]
                                          for k in report["kernels"].values())
    return report


def tiling_gate(quick: bool = True, device: str = "cuda") -> dict:
    """The tile-alignment pruning gate (see the module docstring): one
    tuner serves both sweeps, so the gated one selects among cached trials
    and its winner must come out bit-identical."""
    from repro_torch.kernels.substrate import round_up

    dev = resolve_device(device)
    S, H, hd = _shape(quick)
    candidates = {"flash_attention": [
        {"block_q": 64, "block_k": 64},
        {"block_q": 48, "block_k": 64},     # a 64-row tile, a quarter padding
        {"block_q": 128, "block_k": 128}]}
    misaligned_key = json.dumps({"block_q": 48, "block_k": 64},
                                sort_keys=True)

    def factory(params):
        def fn(x):
            return x
        fn.params = dict(params)
        return fn

    def measure(fn, args):
        p = fn.params
        return float(round_up(p["block_q"], 32) * round_up(p["block_k"], 64))

    x = torch.zeros((1, S, H, hd), dtype=DTYPE, device=dev)
    tuner = KernelAutotuner(candidates=candidates, measure=measure,
                            tile_check=False, device=dev)
    base = tuner.tune("flash_attention", factory, (x,), resource="cloud")
    tuner.tile_check = True                 # gated sweep, same trial table
    gated = tuner.tune("flash_attention", factory, (x,), resource="edge1")
    return {
        "candidates": len(candidates["flash_attention"]),
        "measured_unpruned": len(base.trials),
        "tile_pruned": dict(gated.tile_pruned),
        "misaligned_measured_unpruned": misaligned_key in base.trials,
        "misaligned_in_gated_trials": misaligned_key in gated.trials,
        "winner_params": gated.params,
        "winner_identical": (gated.params == base.params
                             and gated.time_s == base.time_s),
    }


def _inputs(kernel, args, dev, gen):
    """Seeded tensors on ``dev`` of the shapes and dtypes of ``args``."""
    out = []
    for i, a in enumerate(args):
        if a.dtype == torch.int32:          # decode lengths: full caches
            out.append(torch.full(a.shape, args[1].shape[1],
                                  dtype=torch.int32, device=dev))
        elif kernel == "ssd_scan" and i == 1:   # log_a < 0
            out.append(-torch.nn.functional.softplus(torch.randn(
                a.shape, generator=gen, device=dev)).to(a.dtype))
        else:
            out.append(torch.randn(a.shape, generator=gen, device=dev)
                       .to(a.dtype))
    return out


def _launch(kernel, params, xs):
    from repro_torch.kernels import ops
    if kernel == "flash_attention":
        return ops.flash_attention(*xs[:3], causal=True, **params)
    if kernel == "decode_attention":
        return ops.decode_attention(*xs, **params)
    return ops.ssd_scan(*xs, **params)[0]


def _static_smem(kernel, args) -> int:
    """The most static shared memory (``-Xptxas -v``) among the bf16
    instances a launch at ``args``' shapes runs."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import decode_attention as da_mod
    from repro_torch.kernels import flash_attention as fa_mod
    from repro_torch.kernels import ssd_scan as ssd_mod

    report = _build.ptxas_report(kernel)
    if kernel == "flash_attention":
        entries = fa_mod.mma_instances(report)[args[0].shape[3]]
    elif kernel == "decode_attention":
        entries = [da_mod.mma_instances(report)[args[0].shape[2]]]
    else:
        x, la, b = args[0], args[1], args[2]
        entries = [e for v in ssd_mod.mma_passes(
            report, x.shape[3], la.dtype, b.shape[3]).values() for e in v]
    if not entries:
        raise RuntimeError(f"{kernel}: no bf16 instance in the ptxas report")
    return max(e["smem"] for e in entries)


def verify_smem(device: str = "cuda", seed: int = 0) -> dict:
    """``--verify-smem`` (see the module docstring).  Each entry of
    ``kernels`` is one path shape: per candidate its footprint, whether the
    analysis admits it, and on the card the static shared memory, whether
    the launch succeeded and the refusal; ``ok`` is False when a launch
    disagreed with the analysis.  Off the card nothing launches."""
    from repro_torch.analysis.cli import KERNEL_SHAPES
    from repro_torch.analysis.kernel_smem import (H100_SMEM_PER_BLOCK,
                                                  lint_candidates)
    from repro_torch.analysis.tiling import analyze_tiling
    from repro_torch.kernels.substrate import (DEFAULT_CANDIDATES,
                                               DEFAULT_PARAMS,
                                               card_smem_limit)

    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    limit = card_smem_limit(dev) or H100_SMEM_PER_BLOCK
    report = {"device": str(dev), "limit_bytes": limit, "kernels": [],
              "ok": True}
    for kernel, cands in sorted(DEFAULT_CANDIDATES.items()):
        for path, args, options in KERNEL_SHAPES[kernel]:
            kept, pruned, _ = lint_candidates(kernel, cands, args, limit,
                                              options)
            # what a refusal must say: the byte count of a candidate over
            # the limit, the wrapper's reason for one the tiling refuses
            expect = {k: f"needs {n} B of shared memory"
                      for k, n in pruned.items()}
            for p in kept:
                reason = analyze_tiling(kernel, p, args, options).refused
                if reason:
                    expect[json.dumps(p, sort_keys=True)] = reason
            keys = [json.dumps(p, sort_keys=True) for p in kept
                    if json.dumps(p, sort_keys=True) not in expect]
            keys.append(json.dumps(DEFAULT_PARAMS[kernel], sort_keys=True))
            if pruned:
                keys.append(min(pruned, key=pruned.get))
            keys += [k for k in expect if k not in pruned]
            todo = [json.loads(k) for k in dict.fromkeys(keys)]
            entry = {"kernel": kernel, "path": path,
                     "shape": list(args[0].shape), "candidates": []}
            if on_card:
                gen = torch.Generator(device=dev).manual_seed(seed)
                xs = _inputs(kernel, args, dev, gen)
                entry["static_smem"] = _static_smem(kernel, args)
            for params in todo:
                key = json.dumps(params, sort_keys=True)
                c = {"params": params,
                     "smem_bytes": kernel_smem_bytes(kernel, params, args,
                                                     options),
                     "admitted": key not in expect,
                     "expected": expect.get(key)}
                if on_card:
                    try:
                        y = _launch(kernel, params, xs)
                        torch.cuda.synchronize(dev)
                        c["launched"] = bool(torch.isfinite(y).all())
                        c["refusal"] = None
                    except ValueError as e:
                        c["launched"], c["refusal"] = False, str(e)
                    c["agrees"] = (c["launched"] if c["admitted"] else
                                   not c["launched"] and
                                   c["expected"] in c["refusal"])
                    report["ok"] &= c["agrees"]
                entry["candidates"].append(c)
            if on_card:
                del xs
            report["kernels"].append(entry)
    return report


def run(quick: bool = True, device: str = "cuda", measure=None):
    """Sweep -> tuned ``BenchmarkDB`` -> query, then both gates; returns
    the ``name,us_per_call,derived`` rows, and ``run.failures`` names the
    gates that failed."""
    dev = resolve_device(device)
    S, H, hd = _shape(quick)
    resources = [
        Resource("edge1", "edge", EDGE_BOX_1, speed_factor=2.0),
        Resource("cloud", "cloud", CLOUD_VM, speed_factor=1.0),
    ]
    tuner = KernelAutotuner(candidates=_candidates(), runs=1 if quick else 2,
                            measure=measure, device=dev)
    g = _graph(S, H, hd, dev)
    db = benchmark_model(g, resources, TimingProvider(tuner=tuner, device=dev),
                         runs=2 if quick else 5)

    changed = [r for r in tuner.records.values() if r.changed_default]
    print(f"\n# Kernel autotune -> BenchmarkDB -> QueryEngine on {dev}")
    for rec in tuner.records.values():
        mark = "*" if rec.changed_default else " "
        print(f" {mark} {rec.kernel:17s} @{rec.resource:6s} "
              f"default={rec.default_params} -> tuned={rec.params} "
              f"({rec.speedup_vs_default:.2f}x vs default); tile-pruned "
              f"{sorted(rec.tile_pruned)}")
    print(f"  {len(changed)}/{len(tuner.records)} sweeps changed the "
          f"default block size")

    tuned_recs = sum(1 for rs in db.records.values()
                     for r in rs if r.tuned_params)
    net = NetworkModel(default=Link("wired", 0.005, 1e8))
    engine = QueryEngine(db, resources, net, source="edge1",
                         input_bytes=2.0 * S * H * hd)
    result = engine.run(Query(top_n=3))
    best = result.best
    print(f"  {tuned_recs} DB records carry tuned params; best partition: "
          f"{best.describe()} (query {result.query_time_s * 1e3:.1f}ms, "
          f"{result.strategy})")

    gate = smem_gate(quick, dev, measure)
    print(f"  shared-memory gate: limit {gate['limit_bytes']} B, "
          f"{gate['total_pruned']} candidate(s) pruned before timing "
          f"{[sorted(k['pruned']) for k in gate['kernels'].values()]}, "
          f"winners identical to the unconstrained sweep: "
          f"{gate['all_winners_identical']}")
    tgate = tiling_gate(quick, dev)
    print(f"  tiling gate: {len(tgate['tile_pruned'])} misaligned "
          f"candidate(s) pruned before timing {tgate['tile_pruned']}, "
          f"winner identical to the unpruned sweep: "
          f"{tgate['winner_identical']}")
    failures = []
    if gate["total_pruned"] < 1:
        failures.append("smem_gate: no candidate pruned")
    if not gate["all_winners_identical"]:
        failures.append("smem_gate: pruning changed a winner or its time")
    if len(tgate["tile_pruned"]) < 1 or tgate["misaligned_in_gated_trials"]:
        failures.append("tiling_gate: the misaligned candidate was timed")
    if not tgate["winner_identical"]:
        failures.append("tiling_gate: pruning changed the winner or its time")
    run.failures = failures

    rows = [("autotune/sweeps_changed_default", float(len(changed)),
             f"{len(changed)}/{len(tuner.records)}"),
            ("autotune/db_records_tuned", float(tuned_recs), tuned_recs),
            ("autotune/best_latency", best.latency_s * 1e6,
             round(best.latency_s * 1e3, 3)),
            ("autotune/smem_pruned", float(gate["total_pruned"]),
             f"limit={gate['limit_bytes']}B"),
            ("autotune/smem_winner_identical",
             float(gate["all_winners_identical"]),
             gate["all_winners_identical"]),
            ("autotune/tile_pruned", float(len(tgate["tile_pruned"])),
             ";".join(sorted(tgate["tile_pruned"])) or "-"),
            ("autotune/tile_winner_identical",
             float(tgate["winner_identical"]), tgate["winner_identical"])]
    for rec in tuner.records.values():
        rows.append((f"autotune/{rec.kernel}@{rec.resource}",
                     rec.time_s * 1e6,
                     "->".join([str(rec.default_params), str(rec.params)])))
    run.last_gate, run.last_tiling_gate = gate, tgate
    return rows


run.failures = []


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--full", action="store_true",
                    help="larger shapes / more runs")
    ap.add_argument("--device", default="cuda",
                    help="where the kernels run (default: the card)")
    ap.add_argument("--out", default=None,
                    help="write the gate reports as JSON")
    ap.add_argument("--verify-smem", action="store_true",
                    help="hold the shared-memory analysis against the "
                         "card's launches at the paths' shapes")
    args = ap.parse_args()
    rows = run(quick=not args.full, device=args.device)
    report = {"smem_gate": run.last_gate, "tiling_gate": run.last_tiling_gate}
    failures = list(run.failures)
    if args.verify_smem:
        vv = report["verify_smem"] = verify_smem(args.device)
        print(f"  verify-smem on {vv['device']} (limit {vv['limit_bytes']} "
              f"B):")
        for e in vv["kernels"]:
            for c in e["candidates"]:
                print(f"    {e['kernel']} at {e['path']} {c['params']}: "
                      f"{c['smem_bytes']} B dynamic, static "
                      f"{e.get('static_smem', 'not read')} B; admitted "
                      f"{c['admitted']}, launched {c.get('launched')}"
                      + (f", refused: {c['refusal']}" if c.get("refusal")
                         else ""))
        if not vv["ok"]:
            failures.append("verify_smem")
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2, sort_keys=True)
        print(f"  wrote {args.out}")
    print("\nname,us_per_call,derived")
    for name, us, derived in rows:
        print(f"{name},{us:.1f},{derived}")
    if failures:
        raise SystemExit(f"FAILED gates: {', '.join(failures)}")


if __name__ == "__main__":
    main()
