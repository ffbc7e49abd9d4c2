"""FX dataflow lint of fused blocks (SCN5xx): the port of the reference's
jaxpr lint.

Each :class:`repro_torch.core.graph.Block` is a standalone sub-model, the
entity Scission benchmarks, ships across a cut and serves.  This pass
traces every block's ``make_callable`` with
``torch.fx.experimental.proxy_tensor.make_fx`` (``tracing_mode="real"``) on
``meta`` tensors built from the block's ``in_specs``, so every aten op is
recorded with its output's ``node.meta["val"]`` (shape, dtype, device) and
no FLOP runs: weights held by a node's closure follow its input to
``meta``, as ``LayerGraph.trace`` has them.  ``tracing_mode="fake"`` is not
used: it refuses closures that hold real weights.  It lints the dataflow:

* **SCN501** - a float64 value anywhere in the trace (an ``aten._to_copy``
  to f64, an f64 constant): it doubles boundary and shared-memory bytes,
  runs at a fraction of the card's fp32 rate, and every measured time then
  describes a program the deployment never runs.
* **SCN502** - the traced boundary tensor (shape x dtype of the block's
  output) disagrees with the bytes the cost model charges per cut edge
  (``BenchmarkDB.output_bytes`` / the graph's ``out_spec``).
* **SCN503** - a block that fails meta tracing (a ``.item()``, a ``.cpu()``
  or numpy round-trip, a data-dependent shape such as ``nonzero``), or a
  trace holding host-sync ops (``aten._local_scalar_dense``,
  ``aten.nonzero``, ``aten.masked_select``, ``aten.unique*``, a copy to a
  CPU tensor): a host round-trip inside a block is invisible to the
  device's clock and breaks the "block == one device program" premise.  On
  the card (``lint_blocks(..., device="cuda")``) a kernel-bearing block is
  also captured in a CUDA graph (``_device.capture``, the way the tuner and
  the providers time it); a block that cannot be captured is SCN503 too.
* **SCN504** - a contraction (``aten.mm``, ``bmm``, ``addmm``,
  ``baddbmm``, ``_scaled_dot_product_*``, a convolution) with a bf16 or f16
  output on a kernel-bearing block.  The hand-written kernels accumulate
  in fp32 registers by construction (``csrc/*.cu``: ``mma.sync`` with fp32
  accumulators, the SIMT routes in fp32), and on ``meta`` their nodes trace
  their plain versions, which compute in fp32 (``kernels/ref.py``); so
  SCN504 looks at the block's torch ops, where a sub-f32 accumulator beside
  a kernel is a numerics regression, not mixed-precision intent.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch.utils._pytree import tree_leaves

from .diagnostics import Diagnostic, ERROR, WARNING

# ops that wait for the device and copy to the host, by overload packet
HOST_SYNC_OPS = frozenset({
    "aten._local_scalar_dense", "aten.nonzero", "aten.nonzero_static",
    "aten.masked_select", "aten.item",
})
_COPIES = frozenset({"aten._to_copy", "aten.copy_", "aten._copy_from",
                     "aten._copy_from_and_resize"})
CONTRACTIONS = frozenset({
    "aten.mm", "aten.bmm", "aten.addmm", "aten.baddbmm", "aten.matmul",
    "aten.convolution", "aten._convolution", "aten.conv1d", "aten.conv2d",
    "aten.conv3d",
})
_SUB_F32 = (torch.bfloat16, torch.float16)


def _op(node) -> str:
    """``aten.mm`` for a call of ``aten.mm.default``."""
    return str(node.target).rsplit(".", 1)[0] \
        if isinstance(node.target, torch._ops.OpOverload) else ""


def _vals(x) -> list:
    """The tensors of a node's ``meta["val"]`` (a tensor, or a tuple or
    list of them)."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in _vals(v)]
    return []


def _is_host_sync(node) -> bool:
    op = _op(node)
    if op in HOST_SYNC_OPS or op.startswith(("aten.unique", "aten._unique")):
        return True
    if op in _COPIES:
        outs = _vals(node.meta.get("val"))
        ins = [t for a in node.args if hasattr(a, "meta")
               for t in _vals(a.meta.get("val"))]
        return any(t.device.type == "cpu" for t in outs) and \
            any(t.device.type != "cpu" for t in ins)
    return False


def _is_contraction(node) -> bool:
    op = _op(node)
    return op in CONTRACTIONS or op.startswith("aten._scaled_dot_product")


def _has_kernel_node(block) -> bool:
    return any(block.graph.nodes[i].kernel for i in block.node_ids)


def _meta_args(block) -> list[torch.Tensor]:
    return [torch.empty(s.shape, dtype=s.dtype, device="meta")
            for s in block.in_specs]


def trace_block(block):
    """``make_fx`` of the block's callable on ``meta`` inputs.  Each
    recorded value is a fake tensor of one ``FakeTensorMode`` for the
    block, handed to the trace through a ``TracingContext``: left alone,
    ``make_fx`` creates a mode (and walks the Python stack) per value,
    which took 40% of a trace of granite-8b's blocks."""
    from torch._guards import TracingContext, tracing
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.fx.experimental.proxy_tensor import make_fx

    with tracing(TracingContext(FakeTensorMode(allow_fallback_kernels=True))):
        return make_fx(block.make_callable(), tracing_mode="real")(
            *_meta_args(block))


def _capture_error(block, device: torch.device) -> str | None:
    """Why one call of the block on ``device`` cannot be captured in a CUDA
    graph, or None."""
    from .._device import capture

    args = tuple(torch.zeros(s.shape, dtype=s.dtype, device=device)
                 for s in block.in_specs)
    try:
        graph, out = capture(block.make_callable(), args, device)
    except Exception as e:                      # noqa: BLE001 - reported
        torch.cuda.synchronize(device)
        return f"{type(e).__name__}: {e}"
    del out
    graph.reset()
    return None


def lint_block(block, db=None, *, subject: str | None = None,
               device: str | torch.device = "meta") -> list[Diagnostic]:
    """SCN501-504 for one fused block (see the module docstring); on a
    CUDA ``device`` a kernel-bearing block is also captured there."""
    subject = subject or f"block{block.index}/{block.name}"
    diags: list[Diagnostic] = []
    try:
        gm = trace_block(block)
    except Exception as e:                      # noqa: BLE001 - reported
        diags.append(Diagnostic(
            "SCN503", ERROR,
            f"block {block.index} ({block.name}) fails abstract tracing on "
            f"meta tensors: {type(e).__name__}: {str(e)[:300]} - it cannot "
            f"run as a standalone sub-model without a host round-trip, so "
            f"it cannot be benchmarked or served as a stage",
            subject=subject,
            hint="the block must be a function of its entry tensors with "
                 "no host sync (.item(), .cpu(), numpy, data-dependent "
                 "shapes)"))
        return diags

    f64_sites: set[str] = set()
    syncs: set[str] = set()
    subf32: set[str] = set()
    out_node = None
    for node in gm.graph.nodes:
        if node.op == "output":
            out_node = node
            continue
        vals = _vals(node.meta.get("val"))
        if any(t.dtype == torch.float64 for t in vals):
            f64_sites.add(_op(node) or node.op)
        if node.op != "call_function":
            continue
        if _is_host_sync(node):
            syncs.add(_op(node))
        if _is_contraction(node):
            subf32 |= {str(t.dtype).removeprefix("torch.") for t in vals
                       if t.dtype in _SUB_F32}

    if f64_sites:
        diags.append(Diagnostic(
            "SCN501", WARNING,
            f"block {block.index} ({block.name}) carries float64 values "
            f"(produced by {', '.join(sorted(f64_sites))}): f64 doubles "
            f"boundary and shared-memory bytes and runs at a fraction of "
            f"the card's fp32 rate, so measured times and charged cut bytes "
            f"describe a different program", subject=subject,
            hint="cast to float32"))

    if syncs:
        diags.append(Diagnostic(
            "SCN503", ERROR,
            f"block {block.index} ({block.name}) contains host-sync op(s) "
            f"{', '.join(sorted(syncs))}: a host round-trip inside a stage "
            f"is not captured by device time, so the recorded stage time "
            f"undercounts the deployed cost", subject=subject,
            hint="move the host read out of the partitioned graph"))

    if _has_kernel_node(block) and subf32:
        diags.append(Diagnostic(
            "SCN504", WARNING,
            f"block {block.index} ({block.name}) is a kernel path but "
            f"contracts with {', '.join(sorted(subf32))} accumulation: the "
            f"flash/decode/SSD kernels accumulate in fp32 by design - a "
            f"sub-f32 accumulator here is a numerics regression",
            subject=subject,
            hint="contract in float32 (upcast the operands) and cast the "
                 "result"))

    dev = torch.device(device)
    if dev.type == "cuda" and _has_kernel_node(block):
        err = _capture_error(block, dev)
        if err:
            diags.append(Diagnostic(
                "SCN503", ERROR,
                f"block {block.index} ({block.name}) cannot be captured in "
                f"a CUDA graph on {dev}: {err[:300]} - it is not one device "
                f"program, so its replayed time is not its cost",
                subject=subject,
                hint="keep host syncs and pageable copies out of "
                     "kernel-bearing blocks"))

    # SCN502: traced boundary tensor vs the bytes the cost model charges
    outs = [t for a in tree_leaves(out_node.args[0])
            if hasattr(a, "meta") for t in _vals(a.meta.get("val"))]
    traced = sum(t.numel() * t.element_size() for t in outs)
    charged = block.out_spec.nbytes
    source = "graph out_spec"
    if db is not None:
        try:
            charged = int(db.output_bytes(block.index))
            source = "BenchmarkDB.output_bytes"
        except (KeyError, IndexError):
            pass
    if traced != charged:
        dt = ", ".join(sorted({str(t.dtype).removeprefix("torch.")
                               for t in outs}))
        diags.append(Diagnostic(
            "SCN502", WARNING,
            f"block {block.index} ({block.name}) traces to {traced} "
            f"boundary bytes (dtype {dt}) but {source} charges {charged} "
            f"bytes per cut edge - every hop cost in the DP prices the "
            f"wrong transfer", subject=subject,
            hint="re-trace the graph / re-benchmark so out_spec and the "
                 "DB agree with the real boundary tensor"))
    return diags


def lint_blocks(blocks: Sequence, db=None, *,
                device: str | torch.device = "meta") -> list[Diagnostic]:
    """SCN5xx over a fused block list (the unit ``benchmark_model``
    measures and the lattices cut between); ``device`` as
    :func:`lint_block`."""
    diags: list[Diagnostic] = []
    for block in blocks:
        diags.extend(lint_block(block, db=db, device=device))
    return diags
