"""Static Hopper tile-alignment analysis of kernel block-size candidates
(SCN204-207): the port of the reference's TPU tiling analysis.

The hand-written kernels run whole tiles.  The bf16 flash route rounds
``block_q`` up to a multiple of 32 (whole warps of 16 or 32 query rows) and
``block_k`` up to 64 (whole key steps); the bf16 decode route streams the
cache through a ring of 64-row stages; the bf16 SSD route rounds its chunk
up to whole m16 tiles of 16 steps.  A candidate whose block is not such a
multiple still runs, but the launch computes zero-filled, masked rows, so
its measured time describes a padded tile.  The fp32 routes cut their tiles
to the sequence and pad nothing.  A candidate the wrapper would refuse
(bf16 ``block_q`` over 256, an SSD chunk over the route's limit, a head_dim
the route has no instance for) cannot be timed at all.

Both are static functions of (kernel, candidate, argument shapes), and both
come from the kernels' own code: the alignments are the modules' constants
(``Q_ALIGN``, ``KEY_ALIGN``, ``TILE_ROWS``, ``CHUNK_ALIGN``), the launched
tiles their ``tile_sizes`` / ``chunk_length``, and the refusals their
``check_launch``, the function ``_launch`` raises from.  The autotuner
(:class:`repro_torch.kernels.substrate.KernelAutotuner`, ``tile_check``)
prunes with :func:`misaligned_candidates` before timing, and
``adopt_tuned_params`` rejects tuned values through :func:`misaligned_params`.

Codes: SCN204 (a warning for a misaligned candidate; info, with the
wrapper's reason, for a refused one, which the shapes rule out as SCN201's
budget does), SCN205 (info, grid-remainder waste), SCN206 (error, every
candidate misaligned or refused), SCN207 (info, once per sweep: rows that
are not whole 16-byte pieces, or that the bf16 tensor-core tiles pad).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Sequence

import torch

from .diagnostics import Diagnostic, ERROR, INFO, WARNING
from .kernel_smem import kernel_modules, kernel_shapes

# Grid-remainder waste below this fraction is not worth a diagnostic.
WASTE_THRESHOLD = 0.05

# a row is copied between device and shared memory in pieces of this many
# bytes (cp.async 16, one uint4 a thread)
ROW_PIECE = 16


def _dtype(dtype) -> torch.dtype:
    return getattr(torch, dtype) if isinstance(dtype, str) else dtype


def min_tile(kernel: str, dtype) -> dict[str, int]:
    """The multiple each block-size parameter of ``kernel`` must keep in
    ``dtype`` for a launch to pad no row of it: bf16 flash ``block_q`` 32
    and ``block_k`` 64, bf16 decode ``block_k`` 64, bf16 SSD ``chunk`` 16;
    1 for the fp32 routes, which cut tiles to the sequence.  Empty for an
    unknown kernel."""
    mods = kernel_modules()
    if kernel not in mods:
        return {}
    if _dtype(dtype) != torch.bfloat16:
        from ..kernels.substrate import DEFAULT_PARAMS
        return {name: 1 for name in DEFAULT_PARAMS[kernel]}
    mod = mods[kernel]
    if kernel == "flash_attention":
        return {"block_q": mod.Q_ALIGN, "block_k": mod.KEY_ALIGN}
    if kernel == "decode_attention":
        return {"block_k": mod.TILE_ROWS}
    return {"chunk": mod.CHUNK_ALIGN}


def misaligned_params(kernel: str, params: dict, dtype,
                      extents: dict[str, int] | None = None
                      ) -> dict[str, tuple[int, int]]:
    """``{name: (value, multiple)}`` for each parameter of ``params`` that
    is not a multiple of :func:`min_tile`'s.  With ``extents`` (the
    sequence each parameter tiles), a block that covers its whole sequence
    is not the candidate's misalignment: the sequence's remainder is
    (SCN205)."""
    align = min_tile(kernel, dtype)
    out = {}
    for name, value in params.items():
        need = align.get(name, 1)
        if extents and value >= extents.get(name, value + 1):
            continue
        if value % need:
            out[name] = (int(value), need)
    return out


def _extents(kernel: str, shapes) -> dict[str, int]:
    q_or_x, k_or_b = shapes
    if kernel == "flash_attention":
        return {"block_q": q_or_x[1], "block_k": k_or_b[1]}
    if kernel == "decode_attention":
        return {"block_k": k_or_b[1]}
    return {"chunk": q_or_x[1]}


def _grid(kernel: str, params: dict, shapes, dtype) -> dict[str, tuple]:
    """``{axis: (extent, launched tile)}``: the rows a launch walks in
    tiles, the remainder of which it zero-fills and masks."""
    mod = kernel_modules()[kernel]
    q_or_x, k_or_b = shapes
    if kernel == "flash_attention":
        Sq, Sk = q_or_x[1], k_or_b[1]
        bq, bk = mod.tile_sizes(params["block_q"], params["block_k"], Sq, Sk,
                                dtype)
        return {"seq_q": (Sq, bq), "seq_k": (Sk, bk)}
    if kernel == "decode_attention":
        Smax = k_or_b[1]
        tile = mod.TILE_ROWS if dtype == torch.bfloat16 else \
            min(params["block_k"], Smax)
        return {"cache": (Smax, tile)}
    S = q_or_x[1]
    return {"seq": (S, mod.chunk_length(params["chunk"], S, dtype))}


def _rows(kernel: str, shapes, dtype) -> dict[str, str]:
    """Shape-inherent rows a launch copies in pieces smaller than 16 bytes,
    pads to the bf16 tensor-core tiles, or has no bf16 instance for."""
    mod = kernel_modules()[kernel]
    q_or_x, k_or_b = shapes
    size = dtype.itemsize
    out = {}
    if kernel == "ssd_scan":
        widths = {"x": q_or_x[3], "b, c": k_or_b[3]}
    else:
        widths = {"q, k, v": q_or_x[-1]}
    for name, width in widths.items():
        if width * size % ROW_PIECE:
            out[name] = (f"{width} x {size} B = {width * size} B, not whole "
                         f"{ROW_PIECE}-byte pieces")
        elif dtype == torch.bfloat16 and kernel == "ssd_scan" and width % 16:
            out[name] = (f"{width} columns, padded to {-(-width // 16) * 16} "
                         f"for the m16n8k16 tiles")
        elif dtype == torch.bfloat16 and kernel != "ssd_scan" and \
                width not in mod.MMA_HEAD_DIMS:
            out[name] = (f"head_dim {width} has no bf16 instance (takes "
                         f"{list(mod.MMA_HEAD_DIMS)})")
    return out


@dataclass(frozen=True)
class TileAnalysis:
    """Static tiling report for one (kernel, candidate, shape).

    ``misaligned`` maps parameters to ``(value, required multiple)``;
    ``refused`` is the wrapper's reason for refusing the launch, or None;
    ``rows`` the shape-inherent row findings (SCN207); ``grid_waste`` maps
    grid axes to the fraction of the launched tiles that is remainder."""

    kernel: str
    params: dict
    dtype: str
    align: dict[str, int]
    misaligned: dict[str, tuple[int, int]] = field(default_factory=dict)
    refused: str | None = None
    rows: dict[str, str] = field(default_factory=dict)
    grid_waste: dict[str, float] = field(default_factory=dict)

    @property
    def is_aligned(self) -> bool:
        return not self.misaligned

    @property
    def admissible(self) -> bool:
        return self.is_aligned and self.refused is None

    @property
    def waste_fraction(self) -> float:
        return max(self.grid_waste.values(), default=0.0)


def analyze_tiling(kernel: str, params: dict, args: Sequence,
                   options: dict | None = None) -> TileAnalysis | None:
    """Tile analysis of one candidate, or None for a kernel unknown to the
    analysis or arguments it cannot read (the contract of
    :func:`repro_torch.analysis.kernel_smem.kernel_footprint`)."""
    mods = kernel_modules()
    if kernel not in mods:
        return None
    try:
        shapes = kernel_shapes(kernel, args, options)
        dtype = args[0].dtype
        grid = _grid(kernel, params, shapes, dtype)
    except (KeyError, IndexError, AttributeError):
        return None
    waste = {}
    for axis, (extent, tile) in grid.items():
        padded = -(-extent // tile) * tile
        if padded != extent:
            waste[axis] = 1.0 - extent / padded
    return TileAnalysis(
        kernel, dict(params), str(dtype).removeprefix("torch."),
        min_tile(kernel, dtype),
        misaligned_params(kernel, params, dtype, _extents(kernel, shapes)),
        mods[kernel].check_launch(params, shapes, dtype),
        _rows(kernel, shapes, dtype), waste)


def _reason(ta: TileAnalysis) -> str:
    if ta.misaligned:
        parts = ", ".join(f"{n} {got} not a multiple of {need}"
                          for n, (got, need) in sorted(ta.misaligned.items()))
        return (f"misaligned to the {ta.dtype} route's tiles: {parts}; the "
                f"launch computes padded rows")
    return f"refused by the launch: {ta.refused}"


def misaligned_candidates(kernel: str, candidates: Sequence[dict],
                          args: Sequence,
                          options: dict | None = None) -> dict[str, str]:
    """The autotuner's pruning predicate: each misaligned or refused
    candidate's canonical JSON key, mapped to the reason.  Unknown kernels
    flag nothing."""
    flagged: dict[str, str] = {}
    for params in candidates:
        ta = analyze_tiling(kernel, params, args, options)
        if ta is not None and not ta.admissible:
            flagged[json.dumps(params, sort_keys=True)] = _reason(ta)
    return flagged


def lint_tiling(kernel: str, candidates: Sequence[dict], args: Sequence,
                *, options: dict | None = None,
                subject: str = "") -> tuple[list[dict], dict[str, str],
                                            list[Diagnostic]]:
    """Split a candidate sweep into (kept, flagged, diagnostics): the
    tiling twin of
    :func:`repro_torch.analysis.kernel_smem.lint_candidates`.

    ``flagged`` maps each misaligned or refused candidate's canonical JSON
    key to its reason.  SCN204 per flagged candidate (a warning when
    misaligned, info when refused), SCN205 (info) per candidate whose grid
    remainder pads away more than :data:`WASTE_THRESHOLD`, SCN206 (error)
    when no candidate is kept, SCN207 (info, once per sweep) for
    shape-inherent rows.
    """
    subject = subject or kernel
    diags: list[Diagnostic] = []
    kept: list[dict] = []
    flagged: dict[str, str] = {}
    rows_reported = False
    dtype = None
    for params in candidates:
        ta = analyze_tiling(kernel, params, args, options)
        if ta is None:
            kept.append(params)
            continue
        dtype = ta.dtype
        if ta.admissible:
            kept.append(params)
        else:
            flagged[json.dumps(params, sort_keys=True)] = _reason(ta)
            if ta.misaligned:
                align = ", ".join(f"{n} {m}" for n, m in ta.align.items())
                diags.append(Diagnostic(
                    "SCN204", WARNING,
                    f"candidate {params} is {_reason(ta)}, so the measured "
                    f"time stops being representative", subject=subject,
                    hint=f"use multiples of {align}"))
            else:
                diags.append(Diagnostic(
                    "SCN204", INFO,
                    f"candidate {params} is {_reason(ta)}; pruned before "
                    f"timing", subject=subject,
                    hint="the route's limits rule it out at these shapes"))
        if ta.waste_fraction > WASTE_THRESHOLD:
            worst = max(ta.grid_waste, key=ta.grid_waste.get)
            diags.append(Diagnostic(
                "SCN205", INFO,
                f"candidate {params} pads {ta.waste_fraction:.0%} of the "
                f"{worst!r} grid axis away as remainder (zero-filled, "
                f"masked rows)", subject=subject,
                hint="prefer block sizes dividing the sequence length"))
        if ta.rows and not rows_reported:
            rows_reported = True
            parts = "; ".join(f"{n}: {why}"
                              for n, why in sorted(ta.rows.items()))
            diags.append(Diagnostic(
                "SCN207", INFO,
                f"rows the {ta.dtype} route copies in pieces under "
                f"{ROW_PIECE} bytes, pads or refuses: {parts}",
                subject=subject,
                hint="shape-inherent (head/state dim), not tunable per "
                     "candidate"))
    if candidates and not kept and flagged:
        diags.append(Diagnostic(
            "SCN206", ERROR,
            f"every candidate of {kernel!r} is misaligned or refused for "
            f"{dtype} inputs", subject=subject,
            hint="add aligned block sizes the route takes to the sweep"))
    return kept, flagged, diags
