"""Static shared-memory footprints of the Hopper kernels' block-size
candidates (SCN2xx): the port of the reference's VMEM analyzer.

A candidate's footprint is the dynamic shared memory of one CTA at the
block sizes a launch would actually use.  It is not modelled here: each
kernel module's own ``smem_parts`` computes it term by term
(``kernels/flash_attention.py``, ``decode_attention.py``, ``ssd_scan.py``),
after the launch's tile rounding (``tile_sizes``, ``chunk_length``,
``ring_stages``) and mirroring the ``csrc/*.cu`` layout.  The wrapper hands
the total to the kernel, whose C entry point refuses any other figure, so
the analysis and the kernels cannot drift apart: the card checks the one
model at every launch.  This module only maps a graph node's arguments to
the kernel's shapes, as the tuner sees them.

The budget is the card's opt-in shared memory per block
(``substrate.card_smem_limit``) or, off the card, ``H100_SMEM_PER_BLOCK``:
a candidate over it would be refused by the launch, so it is pruned before
timing.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Sequence

from .diagnostics import Diagnostic, ERROR, INFO

# The opt-in maximum of dynamic shared memory one block may use on compute
# capability 9.0 (H100, H200): 227 KB.
H100_SMEM_PER_BLOCK = 232448


def kernel_modules():
    from ..kernels import decode_attention, flash_attention, ssd_scan
    return {"flash_attention": flash_attention,
            "decode_attention": decode_attention, "ssd_scan": ssd_scan}


def known_kernels() -> tuple[str, ...]:
    return tuple(sorted(kernel_modules()))


def kernel_shapes(kernel: str, args: Sequence, options: dict | None = None
                  ) -> tuple[tuple, tuple]:
    """The shapes a kernel's ``smem_bytes`` reads, from its positional
    arguments (tensors or anything with ``.shape``): the kernel's own
    (q, k, v, ...) / (x, log_a, b, c), or a graph node's single input, whose
    missing dimensions come from the node's ``kernel_options`` (a
    self-attention node: k = q; a decode node: its cache of ``cache_len``
    rows over ``kv_heads``; an SSD node: b = c of ``state_dim`` columns)."""
    options = options or {}
    x = tuple(args[0].shape)
    if kernel == "flash_attention":
        return x, tuple(args[1].shape) if len(args) >= 3 else x
    if kernel == "decode_attention":
        if len(args) >= 3:
            return x, tuple(args[1].shape)
        return x, (x[0], options["cache_len"], options["kv_heads"], x[2])
    if kernel == "ssd_scan":
        if len(args) >= 4:
            return x, tuple(args[2].shape)
        return x, (*x[:-1], options.get("state_dim", 16))
    raise KeyError(f"no shared-memory model for kernel {kernel!r}")


@dataclass(frozen=True)
class KernelFootprint:
    """Dynamic shared memory of one CTA for one (kernel, candidate, shape):
    ``parts`` are the terms of the kernel's layout (tiles, scores, ring
    stages ...), in bytes."""

    kernel: str
    params: dict
    dtype: str
    parts: dict[str, int] = field(default_factory=dict)

    @property
    def smem_bytes(self) -> int:
        return sum(self.parts.values())


def kernel_footprint(kernel: str, params: dict, args: Sequence,
                     options: dict | None = None) -> KernelFootprint | None:
    """The footprint of one candidate, or None for a kernel the analysis
    does not know (see :func:`kernel_shapes` for ``args`` and
    ``options``)."""
    mod = kernel_modules().get(kernel)
    if mod is None:
        return None
    dtype = args[0].dtype
    parts = mod.smem_parts(params, kernel_shapes(kernel, args, options),
                           dtype)
    return KernelFootprint(kernel, dict(params),
                           str(dtype).removeprefix("torch."), parts)


def kernel_smem_bytes(kernel: str, params: dict, args: Sequence,
                      options: dict | None = None) -> int | None:
    fp = kernel_footprint(kernel, params, args, options)
    return None if fp is None else fp.smem_bytes


def lint_candidates(kernel: str, candidates: Sequence[dict], args: Sequence,
                    limit: int | None, options: dict | None = None,
                    subject: str = "") -> tuple[list[dict], dict[str, int],
                                                list[Diagnostic]]:
    """Split a candidate sweep into (admissible, pruned, diagnostics).

    ``pruned`` maps the candidate's canonical JSON key to its footprint in
    bytes.  With no ``limit`` (or an unknown kernel) every candidate is
    admissible.  SCN201 (info) per pruned candidate, SCN202 (error) when
    nothing survives, SCN203 (info) when the kernel is unknown.
    """
    subject = subject or kernel
    diags: list[Diagnostic] = []
    if limit is None:
        return list(candidates), {}, diags
    kept: list[dict] = []
    pruned: dict[str, int] = {}
    for params in candidates:
        fp = kernel_footprint(kernel, params, args, options)
        if fp is None:
            diags.append(Diagnostic(
                "SCN203", INFO,
                f"kernel {kernel!r} is unknown to the shared-memory "
                f"analysis; candidate {params} kept unchecked",
                subject=subject,
                hint="give the kernel module a smem_parts and register it "
                     "in repro_torch.analysis.kernel_smem"))
            kept.append(params)
            continue
        if fp.smem_bytes > limit:
            pruned[json.dumps(params, sort_keys=True)] = fp.smem_bytes
            diags.append(Diagnostic(
                "SCN201", INFO,
                f"candidate {params} needs {fp.smem_bytes} B of shared "
                f"memory per CTA in {fp.dtype} (> {limit} B per block); "
                f"pruned before timing", subject=subject,
                hint="shrink the block sizes"))
        else:
            kept.append(params)
    if candidates and not kept:
        diags.append(Diagnostic(
            "SCN202", ERROR,
            f"every candidate of {kernel!r} exceeds the {limit} B of shared "
            f"memory per block (smallest needs "
            f"{min(pruned.values(), default=0)} B)", subject=subject,
            hint="add smaller block-size candidates to the sweep"))
    return kept, pruned, diags
