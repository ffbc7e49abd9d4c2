"""``scission-lint`` for the port: the static-analysis CLI.

Usage::

    PYTHONPATH=src python -m repro_torch.analysis [--strict] [--smem BYTES] \
        [--device cuda|cpu|meta] [--allow CODE ...] [TARGET ...]

Targets:

* ``kernels`` - the shared-memory analysis (SCN201-203) of the default
  autotuner candidate grids at the shapes the port's paths give each kernel
  at full width (:data:`KERNEL_SHAPES`), against the per-block limit:
  ``--smem``, else the card's (``--device cuda``, the default) or
  ``H100_SMEM_PER_BLOCK`` (``--device cpu`` or ``meta``).
* ``graphs`` - the graph IR checker with shape-chain verification on the
  port's MobileNetV2 and ResNet50 and a graph that is not series-parallel.
* ``tiling`` - Hopper tile alignment (SCN204-207) of the same grids at the
  same shapes.
* ``jaxpr`` - the FX dataflow lint (SCN5xx, ``fx_lint``; the name is the
  reference's): every fused block of a kernel demo graph at zamba2-2.7b's
  widths, the 18 zoo nets, granite-8b's ``lm_to_graph`` and the three DAG
  adapters, traced by ``make_fx`` on ``meta``, with an ``AnalyticProvider``
  DB for the byte cross-check; on the card the demo graph's kernel-bearing
  blocks are also captured in CUDA graphs.
* ``cost PATH [PATH ...]`` - cost-model soundness (SCN4xx) over each JSON
  file: a persisted ``BenchmarkDB`` (``"records"``) gets the DB checks; a
  deployment plan (``"block_times"``) also the link checks and the
  additive/minimax composition check on its cost model.
* ``path/to/plan.json`` - lint a deployment-plan file: structural plan
  diagnostics plus (when no structural error already explains it) the
  exact SCN109 joint-satisfiability sweep.

With no targets, ``kernels`` and ``graphs`` both run.  ``--strict`` exits
non-zero when any error- **or warning**-severity diagnostic survives
``--allow`` waivers (``--allow SCN309`` waives a code without silencing its
report).  Diagnostics are deduped by (code, subject) before rendering and
counting.  The plan-file schema is the reference's (``examples/plans/``);
a resource's ``vmem_bytes`` is read by no check and ignored.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from .diagnostics import (Diagnostic, ERROR, WARNING, dedupe, errors,
                          render_report)
from .kernel_smem import H100_SMEM_PER_BLOCK, lint_candidates

# The xLSTM's sLSTM layers unroll one step per token into the trace: at
# 2048 tokens its graph's blocks take tens of seconds to trace on meta, at
# this length a few.
XLSTM_LINT_SEQ = 256


def _meta(*shape, dtype=torch.bfloat16) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _flash(B, S, H, Hk, hd):
    q, k = _meta(B, S, H, hd), _meta(B, S, Hk, hd)
    return (q, k, k), {}


def _decode(B, H, Hk, hd, Smax):
    k = _meta(B, Smax, Hk, hd)
    return (_meta(B, H, hd), k, k, _meta(B, dtype=torch.int32)), {}


def _ssd(B, S, H, P, N):
    b = _meta(B, S, H, N)
    return (_meta(B, S, H, P), _meta(B, S, H), b, b), {}


# The shapes the port's paths give each kernel at full width, bf16.
KERNEL_SHAPES: dict[str, list[tuple[str, tuple, dict]]] = {
    "flash_attention": [
        ("zamba2-2.7b prefill", *_flash(1, 4096, 32, 32, 80)),
        ("whisper-medium encoder", *_flash(8, 1500, 16, 16, 64)),
        ("gemma2-9b prefill", *_flash(1, 4096, 16, 8, 256)),
    ],
    "decode_attention": [
        ("granite-8b decode", *_decode(16, 32, 8, 128, 4096)),
        ("gemma2-9b decode", *_decode(4, 16, 8, 256, 8192)),
    ],
    "ssd_scan": [
        ("zamba2-2.7b prefill", *_ssd(1, 4096, 32, 80, 64)),
        ("xlstm-125m mLSTM", *_ssd(1, 2048, 4, 384, 384)),
    ],
}


def _sweeps():
    from ..kernels.substrate import DEFAULT_CANDIDATES
    for kernel, candidates in sorted(DEFAULT_CANDIDATES.items()):
        for path, args, options in KERNEL_SHAPES[kernel]:
            yield kernel, candidates, path, args, options


def _lint_kernels(limit: int) -> list[Diagnostic]:
    diags: list[Diagnostic] = []
    for kernel, candidates, path, args, options in _sweeps():
        kept, pruned, kdiags = lint_candidates(
            kernel, candidates, args, limit, options,
            subject=f"{kernel}@{path}")
        diags.extend(kdiags)
        print(f"  {kernel} at {path} {tuple(args[0].shape)}: {len(kept)} "
              f"kept / {len(pruned)} pruned of {len(candidates)} candidates "
              f"(limit {limit} B)")
    return diags


def _lint_tiling_target() -> list[Diagnostic]:
    from .tiling import lint_tiling

    diags: list[Diagnostic] = []
    for kernel, candidates, path, args, options in _sweeps():
        kept, flagged, kdiags = lint_tiling(
            kernel, candidates, args, options=options,
            subject=f"{kernel}@{path}")
        diags.extend(kdiags)
        print(f"  {kernel} at {path} {tuple(args[0].shape)}: {len(kept)} "
              f"aligned / {len(flagged)} flagged of {len(candidates)} "
              f"candidates")
    return diags


def _non_sp_example():
    """A graph with a *crossed* skip (a->c and b->d crossing): deliberately
    not series-parallel, so the ``graphs`` target demonstrably exercises
    SCN309, its linearisation fallback, beside the zoo's SP graphs."""
    from ..core.graph import LayerGraph, LayerNode, TensorSpec

    def node(name):
        return LayerNode(name=name, kind="dense", apply=lambda *xs: sum(xs))

    g = LayerGraph("crossed-skips")
    i = g.input(TensorSpec((1, 8), torch.float32))
    a = g.add(node("a"), [i])
    b = g.add(node("b"), [a])
    c = g.add(node("c"), [b, a])     # skip a->c
    g.add(node("d"), [c, b])         # skip b->d crosses it
    g.trace()
    return g


def _lint_graphs() -> list[Diagnostic]:
    from ..models import cnn_zoo
    from .graph_lint import lint_graph

    diags: list[Diagnostic] = []
    for build in (lambda: cnn_zoo.build("MobileNetV2", "meta"),
                  lambda: cnn_zoo.build("ResNet50", "meta"),
                  _non_sp_example):
        g = build()
        gdiags = lint_graph(g, check_shapes=True)
        diags.extend(gdiags)
        codes = sorted({d.code for d in gdiags})
        print(f"  {g.name}: {len(g.nodes)} nodes, {len(gdiags)} diagnostics"
              + (f" [{', '.join(codes)}]" if codes else ""))
    return diags


def demo_kernel_graph():
    """Attention then the SSD scan at zamba2-2.7b's widths (one sequence of
    4096 tokens, 32 heads of 80, SSM state 64, bf16): the graph whose
    blocks trace through the kernel nodes the SCN5xx checks are about.  Its
    nodes hold no weights and run where their input lies: the kernels on
    the card, their plain versions on ``meta``."""
    from ..core.graph import TensorSpec, linear_graph
    from ..kernels.ops import flash_attention_node, ssd_scan_node

    return linear_graph(
        "fx-demo", TensorSpec((1, 4096, 32, 80), torch.bfloat16),
        [flash_attention_node("attn", device="meta"),
         ssd_scan_node("ssd", state_dim=64, device="meta")])


def _lm_graphs():
    """granite-8b's ``lm_to_graph`` (2048 tokens) and the DAG adapters at
    the lengths ``chip_smoke.py`` runs them (xlstm-125m at
    ``XLSTM_LINT_SEQ``), each with ``meta`` weights at full size and its
    fusion."""
    from ..core.graph import fuse_block_dag, fuse_blocks
    from ..models import build_model, get_config
    from ..models.graph_adapter import (encdec_to_graph, lm_to_graph,
                                        moe_to_graph, xlstm_to_graph)

    def model(name):
        m = build_model(get_config(name), device="meta")
        return m, m.init(seed=0, dtype=torch.bfloat16)

    m, p = model("granite-8b")
    yield lm_to_graph(m, p, batch=1, seq_len=2048), fuse_blocks
    m, p = model("whisper-medium")
    yield encdec_to_graph(m, p, batch=1, seq_len=448, enc_splits=2), \
        fuse_block_dag
    m, p = model("qwen2-moe-a2.7b")
    c = m.cfg
    moe_p = {k: v[0] for k, v in p["layers"]["s1_moe"]["moe"].items()
             if k != "shared"}
    yield moe_to_graph(moe_p, batch=1, seq_len=2048, d_model=c.d_model,
                       n_experts=c.moe_experts, top_k=c.moe_top_k,
                       n_shards=2, activation=c.activation,
                       name="qwen2-moe-layer0"), fuse_block_dag
    m, p = model("xlstm-125m")
    yield xlstm_to_graph(m, p, batch=1, seq_len=XLSTM_LINT_SEQ), \
        fuse_block_dag


def _lint_jaxpr_target(device: torch.device) -> list[Diagnostic]:
    from ..core.bench import AnalyticProvider, benchmark_model
    from ..core.graph import fuse_blocks
    from ..core.resources import CLOUD_VM, Resource
    from ..models import cnn_zoo
    from .fx_lint import lint_blocks

    fleet = [Resource("cloud", "cloud", CLOUD_VM)]

    def graphs():
        yield demo_kernel_graph(), fuse_blocks, device
        for name in cnn_zoo.ZOO:
            yield cnn_zoo.build(name, "meta"), fuse_blocks, "meta"
        for graph, fuse in _lm_graphs():
            yield graph, fuse, "meta"

    diags: list[Diagnostic] = []
    for graph, fuse, where in graphs():
        blocks = fuse(graph)
        # an analytic DB, so SCN502 holds the trace against what the cost
        # model would charge
        db = benchmark_model(graph, fleet, AnalyticProvider(), runs=1,
                             blocks=list(blocks))
        gdiags = lint_blocks(blocks, db=db, device=where)
        diags.extend(gdiags)
        captured = " (kernel blocks captured on the card)" \
            if torch.device(where).type == "cuda" else ""
        print(f"  {graph.name}: {len(blocks)} block(s) traced{captured}, "
              f"{len(gdiags)} diagnostics")
    return diags


def _plan_components(plan: dict, path: str):
    from ..core.bench import BenchmarkDB, BlockBenchmark
    from ..core.network import Link, NetworkModel
    from ..core.query import Query
    from ..core.resources import CLOUD_VM, Resource

    resources = [
        Resource(r["name"], r["tier"], CLOUD_VM,
                 speed_factor=float(r.get("speed_factor", 1.0)))
        for r in plan["resources"]]
    n_blocks = int(plan["n_blocks"])
    out_bytes = [int(b) for b in plan["out_bytes"]]
    db = BenchmarkDB(model=plan.get("model", path), n_blocks=n_blocks)
    for name, times in plan["block_times"].items():
        db.records[name] = [
            BlockBenchmark(block=i, resource=name, mean_time_s=float(t),
                           std_time_s=0.0, output_bytes=out_bytes[i], runs=1)
            for i, t in enumerate(times)]
    net = NetworkModel()
    for ln in plan.get("links", ()):
        net.connect(ln["src"], ln["dst"],
                    Link(ln.get("name", f"{ln['src']}-{ln['dst']}"),
                         float(ln["latency_s"]), float(ln["bandwidth"])),
                    symmetric=bool(ln.get("symmetric", True)))

    q = dict(plan.get("query", {}))
    query = Query(
        top_n=int(q.get("top_n", 3)),
        batch_size=int(q.get("batch_size", 1)),
        must_use=tuple(q.get("must_use", ())),
        exclude=tuple(q.get("exclude", ())),
        pin={int(k): v for k, v in q.get("pin", {}).items()},
        max_link_bytes={(a, b): float(v)
                        for a, b, v in q.get("max_link_bytes", ())},
        max_resource_time={k: float(v)
                           for k, v in q.get("max_resource_time", {}).items()},
        min_blocks_on={k: int(v)
                       for k, v in q.get("min_blocks_on", {}).items()},
        pipelines=q.get("pipelines"))
    return db, net, resources, query, plan["source"], float(plan["input_bytes"])


def _load_plan(path: str) -> list[Diagnostic]:
    from ..core.partition import CostModel
    from .plan_lint import explain_empty, lint_plan

    with open(path) as f:
        plan = json.load(f)
    db, net, resources, query, source, input_bytes = \
        _plan_components(plan, path)

    diags = lint_plan(query, resources, net, db, source=source,
                      batches=[query.batch_size])
    if not errors(diags):
        cost = CostModel(db=db, resources=resources, network=net,
                         source=source, input_bytes=input_bytes,
                         batch_size=query.batch_size)
        diags.extend(explain_empty(query, query.constraints(), [cost],
                                   prior=diags))
    return diags


def _lint_cost_file(path: str) -> list[Diagnostic]:
    from ..core.bench import BenchmarkDB
    from ..core.partition import CostModel
    from .cost_lint import lint_cost, lint_cost_db

    with open(path) as f:
        payload = json.load(f)

    if "records" in payload:                  # a persisted BenchmarkDB
        db = BenchmarkDB.from_json(json.dumps(payload))
        print(f"  {db.model}: {len(db.records)} resource(s) x "
              f"{db.n_blocks} block(s)")
        return lint_cost_db(db)

    if "block_times" in payload:              # a deployment plan: full pass
        db, net, resources, query, source, input_bytes = \
            _plan_components(payload, path)
        print(f"  {db.model}: {len(resources)} resource(s) x "
              f"{db.n_blocks} block(s), {len(net.links())} link(s)")
        cost = CostModel(db=db, resources=resources, network=net,
                         source=source, input_bytes=input_bytes,
                         batch_size=query.batch_size)
        return lint_cost(db, network=net,
                         resources=[r.name for r in resources], cost=cost)

    raise ValueError(
        f"{path}: neither a persisted BenchmarkDB ('records') nor a "
        f"deployment plan ('block_times')")


_KEYWORDS = {"kernels", "graphs", "tiling", "jaxpr", "cost"}


def main(argv: list[str] | None = None) -> int:
    from .._device import resolve_device
    from ..kernels.substrate import card_smem_limit

    parser = argparse.ArgumentParser(
        prog="scission-lint",
        description="Static analysis for the port's Scission kernels, "
                    "plans, graphs, cost models and block dataflow")
    parser.add_argument("targets", nargs="*",
                        help="'kernels', 'graphs', 'tiling', 'jaxpr' (the "
                             "FX dataflow lint), 'cost JSON...', and/or "
                             "plan JSON paths (default: kernels graphs)")
    parser.add_argument("--strict", action="store_true",
                        help="exit 1 when any error or warning diagnostic "
                             "survives --allow waivers")
    parser.add_argument("--allow", action="append", default=[],
                        metavar="CODE",
                        help="waive a diagnostic code from the strict "
                             "verdict (repeatable; still reported)")
    parser.add_argument("--smem", type=int, default=None, metavar="BYTES",
                        help="shared memory per block for the kernels "
                             "target (default: the card's on cuda, "
                             f"{H100_SMEM_PER_BLOCK} on cpu or meta)")
    parser.add_argument("--device", default="cuda",
                        help="cuda (the default: reads the card's limit "
                             "and captures the demo graph's kernel blocks "
                             "there), cpu or meta")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    limit = args.smem if args.smem is not None else \
        card_smem_limit(device) or H100_SMEM_PER_BLOCK
    targets = args.targets or ["kernels", "graphs"]
    allow = set(args.allow)

    jobs: list[tuple[str, object]] = []
    i = 0
    while i < len(targets):
        t = targets[i]
        if t == "cost":
            i += 1
            paths = []
            while i < len(targets) and targets[i] not in _KEYWORDS:
                paths.append(targets[i])
                i += 1
            if not paths:
                parser.error("the 'cost' target needs at least one JSON "
                             "path after it")
            for p in paths:
                jobs.append((f"cost {p}", lambda p=p: _lint_cost_file(p)))
            continue
        if t == "kernels":
            jobs.append(("kernels", lambda: _lint_kernels(limit)))
        elif t == "graphs":
            jobs.append(("graphs", _lint_graphs))
        elif t == "tiling":
            jobs.append(("tiling", _lint_tiling_target))
        elif t == "jaxpr":
            jobs.append(("jaxpr", lambda: _lint_jaxpr_target(device)))
        else:
            jobs.append((t, lambda t=t: _load_plan(t)))
        i += 1

    n_errors = n_warnings = 0
    for label, runner in jobs:
        print(f"== scission-lint: {label} ==")
        diags = runner()
        report = render_report(diags)
        if report:
            print(report)
        counted = [d for d in dedupe(diags) if d.code not in allow]
        n_errors += sum(d.severity == ERROR for d in counted)
        n_warnings += sum(d.severity == WARNING for d in counted)
    waived = f", {len(allow)} code(s) waived" if allow else ""
    print(f"scission-lint: {len(jobs)} target(s), {n_errors} error(s), "
          f"{n_warnings} warning(s){waived}")
    if args.strict and (n_errors or n_warnings):
        return 1
    return 0


if __name__ == "__main__":           # pragma: no cover - via __main__.py
    sys.exit(main())
