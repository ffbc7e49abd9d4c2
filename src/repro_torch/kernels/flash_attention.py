"""Flash attention (prefill): the port of the TPU kernel to Hopper.

:func:`flash_attention` launches ``csrc/flash_attention.cu`` for CUDA
tensors, the tensor-core kernel for bf16 and the SIMT kernel for fp32, and
takes the plain PyTorch version (:func:`.ref.flash_attention_ref`) for
tensors on the CPU or on ``meta`` (shape tracing).  On a CUDA tensor it
launches a kernel or raises; it never falls back.  ``launches`` counts the
kernel launches.
"""

from __future__ import annotations

import re

import torch

from . import _build
from .ref import flash_attention_ref
from .substrate import card_smem_limit

launches = 0

MMA_HEAD_DIMS = range(16, 257, 16)     # head_dims of the bf16 route
MAX_BLOCK_Q = 256                      # query rows of a CTA (bf16 route)
Q_ALIGN = 32                           # query rows of a warp, at most
KEY_ALIGN = 64                         # the bf16 route's widest key step


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def tile_sizes(block_q: int, block_k: int, Sq: int, Sk: int,
               dtype: torch.dtype) -> tuple[int, int]:
    """The (block_q, block_k) a launch uses.  The fp32 route cuts each to
    its sequence; the bf16 route rounds ``min(block_q, Sq)`` up to a
    multiple of 32 (whole warps of 16 or 32 query rows) and ``min(block_k,
    Sk)`` up to a multiple of 64 (whole key steps); rows past Sq or Sk are
    zero-filled and masked."""
    bq, bk = min(block_q, Sq), min(block_k, Sk)
    if dtype == torch.bfloat16:
        return _round_up(bq, Q_ALIGN), _round_up(bk, KEY_ALIGN)
    return bq, bk


def mma_instances(per_kernel: dict) -> dict[int, list]:
    """A per-kernel report of ``libflash_attention.so`` (mangled name ->
    value, as :func:`._build.ptxas_report` gives it), grouped by the
    head_dim of its bf16 instances ``fa_mma_kernel<hd, ...>``; the fp32
    kernel is left out."""
    out: dict[int, list] = {}
    for name, value in per_kernel.items():
        if m := re.search(r"fa_mma_kernelILi(\d+)E", name):
            out.setdefault(int(m.group(1)), []).append(value)
    return out


def smem_bytes(params: dict, shapes, dtype: torch.dtype) -> int:
    """Dynamic shared memory of one CTA for ``params`` = {block_q, block_k}
    at ``shapes`` = (q shape, k shape) in ``dtype``; mirrors
    ``fa_mma_smem_bytes`` (bf16: the q tile and two stages of k and v
    tiles, rows padded to hd + 8) and ``fa_smem_floats`` (fp32) in
    ``csrc/flash_attention.cu``."""
    q_shape, k_shape = shapes[0], shapes[1]
    Sq, hd, Sk = q_shape[1], q_shape[3], k_shape[1]
    bq, bk = tile_sizes(params["block_q"], params["block_k"], Sq, Sk, dtype)
    if dtype == torch.bfloat16:
        return 2 * (hd + 8) * (bq + 4 * bk)
    return 4 * (bq * hd + bk * (hd + 1) + bk * hd + bq * bk + bq * hd + 3 * bq)


def flash_attention(q, k, v, *, causal=True, window=None, softcap=None,
                    block_q=128, block_k=128):
    """q: (B, Sq, H, hd); k, v: (B, Sk, Hk, hd) -> (B, Sq, H, hd) in q's
    dtype.  ``Sq``/``Sk`` need not divide the block sizes."""
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"expected q (B,Sq,H,hd) and k, v (B,Sk,Hk,hd), "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, Sq, H, hd = q.shape
    if k.shape[0] != B or k.shape[3] != hd or H % k.shape[2]:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"softcap must be > 0, got {softcap}")
    if block_q < 1 or block_k < 1:
        raise ValueError(f"block sizes must be >= 1, got {block_q}, {block_k}")
    if q.device.type in ("cpu", "meta"):
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    return _launch(q, k, v, causal, window, softcap, block_q, block_k)


def _launch(q, k, v, causal, window, softcap, block_q, block_k):
    global launches
    if q.dtype not in _build.DTYPE_CODES or k.dtype != q.dtype or \
            v.dtype != q.dtype:
        raise ValueError(f"flash_attention kernel takes float32 or bfloat16 "
                         f"q, k, v of one dtype, got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    if not (k.device == q.device == v.device):
        raise ValueError("q, k, v must be on one device")
    B, Sq, H, hd = q.shape
    Sk, Hk = k.shape[1], k.shape[2]
    bq, bk = tile_sizes(block_q, block_k, Sq, Sk, q.dtype)
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    if q.dtype == torch.bfloat16:
        if hd not in MMA_HEAD_DIMS:
            raise ValueError(f"flash_attention's bf16 kernel takes head_dim "
                             f"a multiple of 16 up to 256, got {hd}")
        if bq > MAX_BLOCK_Q:
            raise ValueError(f"flash_attention's bf16 kernel takes block_q "
                             f"<= {MAX_BLOCK_Q}, got {block_q}")
        for name, t in (("q", q), ("k", k), ("v", v)):
            if t.data_ptr() % 16 or any(t.stride(i) * 2 % 16
                                        for i in range(3)):
                raise ValueError(f"flash_attention's bf16 kernel reads {name} "
                                 f"rows as 16-byte pieces: its storage and "
                                 f"strides {t.stride()} must be 16-byte "
                                 f"aligned")
    nbytes = smem_bytes({"block_q": block_q, "block_k": block_k},
                        (q.shape, k.shape), q.dtype)
    limit = card_smem_limit(q.device)
    if nbytes > limit:
        raise ValueError(f"flash_attention block_q={block_q}, "
                         f"block_k={block_k} at head_dim {hd} in {q.dtype} "
                         f"needs {nbytes} B of shared memory; the card "
                         f"allows {limit} B")
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lib = _build.library("flash_attention")
    code = lib.fa_forward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        _build.DTYPE_CODES[q.dtype], B, Sq, Sk, H, Hk, hd,
        _build.strides(q, k, v, o), bq, bk, int(causal), window or 0,
        float(softcap or 0.0), nbytes,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check("flash_attention", code)
    launches += 1
    return o
