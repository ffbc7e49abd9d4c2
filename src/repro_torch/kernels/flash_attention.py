"""Flash attention (prefill): the port of the TPU kernel to Hopper.

:func:`flash_attention` launches ``csrc/flash_attention.cu`` for CUDA
tensors, the tensor-core kernel for bf16 and the SIMT kernel for fp32, and
takes the plain PyTorch version (:func:`.ref.flash_attention_ref`) for
tensors on the CPU or on ``meta`` (shape tracing).  On a CUDA tensor it
launches a kernel or raises; it never falls back.  The
``flash_attention_launches`` counter of :mod:`..tracing` counts the kernel
launches.

The kernel has no backward.  When gradients are asked for (grad mode on
and an input that requires grad), a CUDA call goes through
:class:`.substrate.KernelFunction`, whose backward differentiates the plain
version recomputed from the saved inputs
(``flash_attention_backward_launches``).  Each call is a
``kernel.flash_attention`` span of :mod:`..tracing`, each backward a
``kernel.flash_attention.backward`` span with CUDA events.
"""

from __future__ import annotations

import re

import torch

from .. import tracing
from . import _build, sharded
from .ref import flash_attention_ref
from .substrate import (DEFAULT_PARAMS, KernelFunction, card_smem_limit,
                        serving_param)

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


def smem_parts(params: dict, shapes, dtype: torch.dtype) -> dict[str, int]:
    """Dynamic shared memory of one CTA for ``params`` = {block_q, block_k}
    at ``shapes`` = (q shape, k shape) in ``dtype``, term by term at the
    tile sizes a launch uses (:func:`tile_sizes`); mirrors
    ``fa_mma_smem_bytes`` (bf16: the q tile and two stages of k and v
    tiles, rows padded to hd + 8) and ``fa_smem_floats`` (fp32) in
    ``csrc/flash_attention.cu``."""
    q_shape, k_shape = shapes[0], shapes[1]
    Sq, hd, Sk = q_shape[1], q_shape[3], k_shape[1]
    bq, bk = tile_sizes(params["block_q"], params["block_k"], Sq, Sk, dtype)
    if dtype == torch.bfloat16:
        row = 2 * (hd + 8)
        return {"q": row * bq, "k": row * 2 * bk, "v": row * 2 * bk}
    return {"q": 4 * bq * hd, "k": 4 * bk * (hd + 1), "v": 4 * bk * hd,
            "scores": 4 * bq * bk, "acc": 4 * bq * hd,
            "softmax": 4 * 3 * bq}


def smem_bytes(params: dict, shapes, dtype: torch.dtype) -> int:
    """The total of :func:`smem_parts`: the figure a launch hands the
    kernel, which refuses any other."""
    return sum(smem_parts(params, shapes, dtype).values())


def check_launch(params: dict, shapes, dtype: torch.dtype,
                 limit: int | None = None) -> str | None:
    """Why a launch at block sizes ``params`` = {block_q, block_k} (as
    :func:`block_sizes` gives them) on ``shapes`` = (q shape, k shape) in
    ``dtype`` would be refused, or None; ``limit`` is the card's shared
    memory per block (None: not checked)."""
    hd = shapes[0][3]
    if dtype not in _build.DTYPE_CODES:
        return (f"flash_attention kernel takes float32 or bfloat16 q, k, v, "
                f"got {dtype}")
    if dtype == torch.bfloat16:
        bq, _ = tile_sizes(params["block_q"], params["block_k"],
                           shapes[0][1], shapes[1][1], dtype)
        if hd not in MMA_HEAD_DIMS:
            return (f"flash_attention's bf16 kernel takes head_dim a "
                    f"multiple of 16 up to 256, got {hd}")
        if bq > MAX_BLOCK_Q:
            return (f"flash_attention's bf16 kernel takes block_q <= "
                    f"{MAX_BLOCK_Q}, got {params['block_q']}")
    nbytes = smem_bytes(params, shapes, dtype)
    if limit is not None and nbytes > limit:
        return (f"flash_attention block_q={params['block_q']}, "
                f"block_k={params['block_k']} at head_dim {hd} in {dtype} "
                f"needs {nbytes} B of shared memory; the card allows "
                f"{limit} B")
    return None


def block_sizes(q, k, block_q=None, block_k=None) -> tuple[int, int]:
    """The (block_q, block_k) a launch on ``q``, ``k`` uses.  A size given
    is used as it is (a launch refuses one whose tiles do not fit); a size
    left None is the adopted tuned one (``substrate.serving_param``), else
    the default, halved (the larger first, block_k on a tie) while the
    card's shared memory cannot hold the tiles at this head_dim and dtype:
    bf16 at head_dim 256 cannot hold 128 x 128."""
    bq = block_q if block_q is not None else serving_param(
        "flash_attention", "block_q",
        DEFAULT_PARAMS["flash_attention"]["block_q"])
    bk = block_k if block_k is not None else serving_param(
        "flash_attention", "block_k",
        DEFAULT_PARAMS["flash_attention"]["block_k"])
    limit = card_smem_limit(q.device)
    while limit is not None and smem_bytes(
            {"block_q": bq, "block_k": bk}, (q.shape, k.shape),
            q.dtype) > limit:
        free_q = block_q is None and bq > 16
        if block_k is None and bk > 16 and (bk >= bq or not free_q):
            bk //= 2
        elif free_q:
            bq //= 2
        else:
            break
    return bq, bk


def flash_attention(q, k, v, *, causal=True, window=None, softcap=None,
                    block_q=None, block_k=None):
    """q: (B, Sq, H, hd); k, v: (B, Sk, Hk, hd) -> (B, Sq, H, hd) in q's
    dtype.  ``Sq``/``Sk`` need not divide the block sizes; sizes left None
    are chosen by :func:`block_sizes`."""
    with tracing.span("kernel.flash_attention"):
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
        if (block_q is not None and block_q < 1) or \
                (block_k is not None and block_k < 1):
            raise ValueError(f"block sizes must be >= 1, got {block_q}, "
                             f"{block_k}")
        if sharded.is_dtensor(q):
            return sharded.flash_attention(
                flash_attention, q, k, v, causal=causal, window=window,
                softcap=softcap, block_q=block_q, block_k=block_k)
        if q.device.type in ("cpu", "meta"):
            return flash_attention_ref(q, k, v, causal=causal, window=window,
                                       softcap=softcap)
        if q.device.type != "cuda":
            raise ValueError(f"flash_attention: unsupported device {q.device}")
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or
                                        v.requires_grad):
            return KernelFunction.apply(
                "flash_attention",
                lambda *t: _launch(*t, causal, window, softcap, block_q,
                                   block_k),
                lambda *t: flash_attention_ref(*t, causal=causal,
                                               window=window, softcap=softcap),
                q, k, v)
        return _launch(q, k, v, causal, window, softcap, block_q, block_k)


def _launch(q, k, v, causal, window, softcap, block_q, block_k):
    if q.dtype not in _build.DTYPE_CODES or k.dtype != q.dtype or \
            v.dtype != q.dtype:
        raise ValueError(f"flash_attention kernel takes float32 or bfloat16 "
                         f"q, k, v of one dtype, got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    if not (k.device == q.device == v.device):
        raise ValueError("q, k, v must be on one device")
    B, Sq, H, hd = q.shape
    Sk, Hk = k.shape[1], k.shape[2]
    block_q, block_k = block_sizes(q, k, block_q, block_k)
    params = {"block_q": block_q, "block_k": block_k}
    reason = check_launch(params, (q.shape, k.shape), q.dtype,
                          card_smem_limit(q.device))
    if reason:
        raise ValueError(reason)
    bq, bk = tile_sizes(block_q, block_k, Sq, Sk, q.dtype)
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    if q.dtype == torch.bfloat16:
        for name, t in (("q", q), ("k", k), ("v", v)):
            if t.data_ptr() % 16 or any(t.stride(i) * 2 % 16
                                        for i in range(3)):
                raise ValueError(f"flash_attention's bf16 kernel reads {name} "
                                 f"rows as 16-byte pieces: its storage and "
                                 f"strides {t.stride()} must be 16-byte "
                                 f"aligned")
    nbytes = smem_bytes(params, (q.shape, k.shape), q.dtype)
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lib = _build.library("flash_attention")
    code = lib.fa_forward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        _build.DTYPE_CODES[q.dtype], B, Sq, Sk, H, Hk, hd,
        _build.strides(q, k, v, o), bq, bk, int(causal), window or 0,
        float(softcap or 0.0), nbytes,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check("flash_attention", code)
    tracing.count("flash_attention_launches")
    return o
