"""Flash attention (prefill): the port of the TPU kernel to Hopper.

:func:`flash_attention` launches ``csrc/flash_attention.cu`` for CUDA
tensors and takes the plain PyTorch version (:func:`.ref.flash_attention_ref`)
for tensors on the CPU or on ``meta`` (shape tracing).  On a CUDA tensor it
launches the kernel or raises; it never falls back.  ``launches`` counts the
kernel launches.
"""

from __future__ import annotations

import torch

from . import _build
from .ref import flash_attention_ref
from .substrate import card_smem_limit

launches = 0


def smem_bytes(params: dict, shapes) -> int:
    """Dynamic shared memory of one CTA for ``params`` = {block_q, block_k}
    at ``shapes`` = (q shape, k shape); mirrors ``fa_smem_floats`` in
    ``csrc/flash_attention.cu``."""
    q_shape, k_shape = shapes[0], shapes[1]
    Sq, hd, Sk = q_shape[1], q_shape[3], k_shape[1]
    bq, bk = min(params["block_q"], Sq), min(params["block_k"], Sk)
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
    bq, bk = min(block_q, Sq), min(block_k, Sk)
    nbytes = smem_bytes({"block_q": bq, "block_k": bk}, (q.shape, k.shape))
    limit = card_smem_limit(q.device)
    if nbytes > limit:
        raise ValueError(f"flash_attention block_q={block_q}, "
                         f"block_k={block_k} at head_dim {hd} needs {nbytes} "
                         f"B of shared memory; the card allows {limit} B")
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
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
