"""Mamba-2 SSD chunked scan: the port of the TPU kernel to Hopper.

:func:`ssd_scan` launches ``csrc/ssd_scan.cu`` for CUDA tensors, the
chunk-parallel tensor-core passes for bf16 x and the SIMT kernel for fp32,
and takes the plain PyTorch version (:func:`.ref.ssd_ref`) for tensors on
the CPU or on ``meta`` (shape tracing).  On a CUDA tensor it launches a
kernel or raises; it never falls back.  ``launches`` counts calls that
launched the kernel: the bf16 route's three passes count once;
``wide_launches`` counts those of them that took the wide route (P > 128
or N > 64, the mLSTM's 384-wide heads).
"""

from __future__ import annotations

import re

import torch

from . import _build
from .ref import ssd_ref
from .substrate import card_smem_limit

launches = 0
wide_launches = 0

MAX_CHUNK = 256         # bf16 route: csrc/ssd_scan.cu kMaxChunk
# bf16 route up to 8 * kMaxPT and 16 * kMaxNK; beyond, the wide route
# (P and N up to kMaxWidth, chunk up to kWideMaxChunk)
NARROW_P, NARROW_N = 128, 64
MAX_P = MAX_N = 384
MAX_WIDE_CHUNK = 128


def wide(P: int, N: int) -> bool:
    """Whether a bf16 launch at widths P, N takes the wide route (pass 1
    tiled over the state, pass 3 ``ssd_chunk_scan_wide`` streaming N)."""
    return P > NARROW_P or N > NARROW_N


def mma_tiles(P: int, N: int = 0) -> int:
    """The n8 tiles of P the bf16 instance a launch at widths ``P``, ``N``
    runs holds (``launch_chunked_p`` in ``csrc/ssd_scan.cu``): the wide
    route's P tiles are 128 wide."""
    Pp = _round16(P)
    if wide(P, N):
        return 16
    return 4 if Pp <= 32 else 8 if Pp <= 64 else 10 if Pp <= 80 else 16


def mma_passes(per_kernel: dict, P: int | None = None,
               la_dtype: torch.dtype | None = None,
               N: int = 0) -> dict[str, list]:
    """A per-kernel report of ``libssd_scan.so`` (mangled name -> value, as
    :func:`._build.ptxas_report` gives it) reduced to the bf16 route's
    tensor-core passes, ``ssd_chunk_state``, ``ssd_chunk_scan`` and
    ``ssd_chunk_scan_wide``, each with its instances (per ``log_a`` dtype
    and P's n8 tiles), or only the instances a launch at widths ``P``,
    ``N`` with ``log_a`` in ``la_dtype`` runs."""
    la = {None: r"\w+?", torch.float32: "f",
          torch.bfloat16: "13__nv_bfloat16"}[la_dtype]
    pt = r"\d+" if P is None else str(mma_tiles(P, N))
    scan = "ssd_chunk_scan" if P is None else \
        "ssd_chunk_scan_wide" if wide(P, N) else "ssd_chunk_scan(?!_wide)"
    out: dict[str, list] = {}
    for name, value in per_kernel.items():
        if m := re.search(rf"(ssd_chunk_state|{scan}\w*?)I{la}Li{pt}E",
                          name):
            out.setdefault(m.group(1), []).append(value)
    return out


def _round16(n: int) -> int:
    return -(-n // 16) * 16


def chunk_length(chunk: int, S: int, dtype: torch.dtype) -> int:
    """The chunk length a launch uses: ``min(chunk, S)``, rounded up to a
    multiple of 16 (whole m16 tiles) in bf16; steps past S are padding."""
    L = min(chunk, S)
    return _round16(L) if dtype == torch.bfloat16 else L


def smem_bytes(params: dict, shapes, dtype: torch.dtype) -> int:
    """Dynamic shared memory of one CTA for ``params`` = {chunk} at
    ``shapes`` = (x shape, b shape) with x in ``dtype``; mirrors
    ``csrc/ssd_scan.cu``: in bf16 ``chunked_smem``, the larger of the
    chunk-state and chunk-scan passes (bf16 rows padded to a multiple of
    16 plus 8; on the wide route a 64 x 128 state tile in pass 1, and in
    pass 3 a 128-wide P tile of x and S_in slabs of 64 rows), in fp32
    ``ssd_smem_floats``."""
    x_shape, b_shape = shapes[0], shapes[1]
    S, P, N = x_shape[1], x_shape[3], b_shape[3]
    L = chunk_length(params["chunk"], S, dtype)
    if dtype == torch.bfloat16 and wide(P, N):
        sx, sn = NARROW_P + 8, NARROW_N + 8
        state = 2 * L * sn + 2 * L * sx + 4 * L
        scan = 2 * L * sx + 4 * NARROW_N * sx + 8 * L + 4 * L * sn
        return max(state, scan)
    if dtype == torch.bfloat16:
        sx, sn = _round16(P) + 8, _round16(N) + 8
        state = 2 * L * sn + 2 * L * sx + 4 * L
        scan = 4 * L * sn + 2 * L * sx + 4 * _round16(N) * sx + 8 * L
        return max(state, scan)
    return 4 * (L * P + 2 * L * (N + 1) + L * L + N * P + 3 * L)


def workspace_bytes(params: dict, shapes, dtype: torch.dtype) -> int:
    """Device memory of the fp32 workspace a call allocates: in bf16 the
    (B, H, nc, N, P) chunk states and (B, H, nc) decays the passes hand on;
    the fp32 route needs none."""
    if dtype != torch.bfloat16:
        return 0
    x_shape, b_shape = shapes[0], shapes[1]
    B, S, H, P = x_shape
    N = b_shape[3]
    nc = -(-S // chunk_length(params["chunk"], S, dtype))
    return 4 * B * H * nc * (N * P + 1)


def ssd_scan(x, log_a, b, c, *, chunk=128):
    """x: (B, S, H, P); log_a: (B, S, H); b, c: (B, S, H, N).

    Returns (y: (B, S, H, P) in x's dtype, final_state: (B, H, N, P) fp32).
    ``S`` need not divide the chunk length.
    """
    if x.ndim != 4 or log_a.shape != x.shape[:3] or b.ndim != 4 or \
            b.shape != c.shape or b.shape[:3] != x.shape[:3]:
        raise ValueError(f"expected x (B,S,H,P), log_a (B,S,H), b, c "
                         f"(B,S,H,N), got {tuple(x.shape)}, "
                         f"{tuple(log_a.shape)}, {tuple(b.shape)}, "
                         f"{tuple(c.shape)}")
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    if x.device.type in ("cpu", "meta"):
        return ssd_ref(x, log_a, b, c, chunk=chunk)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan: unsupported device {x.device}")
    return _launch(x, log_a, b, c, chunk)


def _launch(x, log_a, b, c, chunk):
    global launches, wide_launches
    if x.dtype not in _build.DTYPE_CODES or b.dtype != x.dtype or \
            c.dtype != x.dtype or log_a.dtype not in _build.DTYPE_CODES:
        raise ValueError(f"ssd_scan kernel takes float32 or bfloat16 x, b, c "
                         f"of one dtype and a float32 or bfloat16 log_a, got "
                         f"{x.dtype}, {b.dtype}, {c.dtype}, {log_a.dtype}")
    if not (log_a.device == b.device == c.device == x.device):
        raise ValueError("x, log_a, b, c must be on one device")
    B, S, H, P = x.shape
    N = b.shape[-1]
    L = chunk_length(chunk, S, x.dtype)
    if x.dtype == torch.bfloat16 and (
            L > MAX_CHUNK or P > MAX_P or N > MAX_N or
            (wide(P, N) and L > MAX_WIDE_CHUNK)):
        raise ValueError(f"ssd_scan's bf16 kernel takes chunk <= "
                         f"{MAX_CHUNK} with P <= {NARROW_P} and N <= "
                         f"{NARROW_N}, or chunk <= {MAX_WIDE_CHUNK} with P "
                         f"and N <= {MAX_P}, got chunk={chunk}, P={P}, "
                         f"N={N}")
    params, shapes = {"chunk": L}, (x.shape, b.shape)
    nbytes = smem_bytes(params, shapes, x.dtype)
    limit = card_smem_limit(x.device)
    if nbytes > limit:
        route = "fp32" if x.dtype == torch.float32 else "bf16"
        raise ValueError(f"ssd_scan's {route} kernel at chunk={chunk}, "
                         f"P={P}, N={N} needs {nbytes} B of shared memory; "
                         f"the card allows {limit} B")
    x, b, c = (t if t.stride(-1) == 1 else t.contiguous() for t in (x, b, c))
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    fin = torch.empty((B, H, N, P), dtype=torch.float32, device=x.device)
    ws = torch.empty(workspace_bytes(params, shapes, x.dtype) // 4,
                     dtype=torch.float32, device=x.device)
    code = _build.library("ssd_scan").ssd_forward(
        x.data_ptr(), log_a.data_ptr(), b.data_ptr(), c.data_ptr(),
        y.data_ptr(), fin.data_ptr(), ws.data_ptr(),
        _build.DTYPE_CODES[x.dtype], _build.DTYPE_CODES[log_a.dtype], B, S,
        H, P, N, _build.strides(x, log_a, b, c, y), L, nbytes,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check("ssd_scan", code)
    launches += 1
    wide_launches += x.dtype == torch.bfloat16 and wide(P, N)
    return y, fin
