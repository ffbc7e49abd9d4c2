"""Mamba-2 SSD chunked scan: the port of the TPU kernel to Hopper.

:func:`ssd_scan` launches ``csrc/ssd_scan.cu`` for CUDA tensors and takes
the plain PyTorch version (:func:`.ref.ssd_ref`) for tensors on the CPU or
on ``meta`` (shape tracing).  On a CUDA tensor it launches the kernel or
raises; it never falls back.  ``launches`` counts the kernel launches.
"""

from __future__ import annotations

import torch

from . import _build
from .ref import ssd_ref
from .substrate import card_smem_limit

launches = 0


def smem_bytes(params: dict, shapes) -> int:
    """Dynamic shared memory of one CTA for ``params`` = {chunk} at
    ``shapes`` = (x shape, b shape); mirrors ``ssd_smem_floats`` in
    ``csrc/ssd_scan.cu``."""
    x_shape, b_shape = shapes[0], shapes[1]
    S, P, N = x_shape[1], x_shape[3], b_shape[3]
    L = min(params["chunk"], S)
    return 4 * (L * P + 2 * L * (N + 1) + L * L + N * P + 3 * L)


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
    global launches
    if x.dtype not in _build.DTYPE_CODES or b.dtype != x.dtype or \
            c.dtype != x.dtype or log_a.dtype not in _build.DTYPE_CODES:
        raise ValueError(f"ssd_scan kernel takes float32 or bfloat16 x, b, c "
                         f"of one dtype and a float32 or bfloat16 log_a, got "
                         f"{x.dtype}, {b.dtype}, {c.dtype}, {log_a.dtype}")
    if not (log_a.device == b.device == c.device == x.device):
        raise ValueError("x, log_a, b, c must be on one device")
    B, S, H, P = x.shape
    N = b.shape[-1]
    L = min(chunk, S)
    nbytes = smem_bytes({"chunk": L}, (x.shape, b.shape))
    limit = card_smem_limit(x.device)
    if nbytes > limit:
        raise ValueError(f"ssd_scan chunk={chunk} at P={P}, N={N} needs "
                         f"{nbytes} B of shared memory; the card allows "
                         f"{limit} B")
    x, b, c = (t if t.stride(-1) == 1 else t.contiguous() for t in (x, b, c))
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    fin = torch.empty((B, H, N, P), dtype=torch.float32, device=x.device)
    lib = _build.library("ssd_scan")
    code = lib.ssd_forward(
        x.data_ptr(), log_a.data_ptr(), b.data_ptr(), c.data_ptr(),
        y.data_ptr(), fin.data_ptr(), _build.DTYPE_CODES[x.dtype],
        _build.DTYPE_CODES[log_a.dtype], B, S, H, P, N,
        _build.strides(x, log_a, b, c, y), L, nbytes,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check("ssd_scan", code)
    launches += 1
    return y, fin
