"""Decode attention (one new token against a KV cache): the port of the TPU
kernel to Hopper.

:func:`decode_attention` launches ``csrc/decode_attention.cu`` for CUDA
tensors and takes the plain PyTorch version
(:func:`.ref.decode_attention_ref`) for tensors on the CPU or on ``meta``
(shape tracing).  On a CUDA tensor it launches the kernel or raises; it
never falls back.  ``launches`` counts calls that launched the kernel:
each call launches a pass over the split cache and a pass that combines
the splits, and counts once.

``lengths`` must lie in ``[0, Smax]``.  The launch path never reads them
back to the host (that would synchronise every call); the kernel clamps
them into that range, which is what the plain version's mask does with
values outside it.
"""

from __future__ import annotations

import torch

from . import _build
from .ref import decode_attention_ref
from .substrate import card_smem_limit

launches = 0

THREADS = 256           # csrc/decode_attention.cu kThreads
WARPS = THREADS // 32
CTAS_PER_SM = 4         # split the cache until the grid holds ~4 per SM


def group_pad(G: int) -> int:
    """Query heads one CTA carries for a group of ``G``: G rounded up to
    1, 2, 4 or 8 (larger groups are cut into pieces of 8)."""
    return 1 if G <= 1 else 2 if G <= 2 else 4 if G <= 4 else 8


def _align16(n: int) -> int:
    return -(-n // 16) * 16


def smem_bytes(params: dict, shapes, dtype: torch.dtype) -> int:
    """Dynamic shared memory of one CTA for ``params`` = {block_k} at
    ``shapes`` = (q shape, k shape) in ``dtype``; mirrors ``da_layout`` in
    ``csrc/decode_attention.cu``: the k and v tiles in the input's dtype,
    fp32 scores, q group, reduction slots and row-group accumulators."""
    q_shape, k_shape = shapes[0], shapes[1]
    H, hd = q_shape[1], q_shape[2]
    Smax, Hk = k_shape[1], k_shape[2]
    gp = group_pad(H // Hk)
    bk = min(params["block_k"], Smax)
    tile = _align16(bk * hd * dtype.itemsize)
    return (2 * tile + _align16(bk * gp * 4) + _align16(gp * hd * 4)
            + _align16(2 * WARPS * gp * 4) + (THREADS // hd) * gp * hd * 4)


def num_splits(ctas: int, n_tiles: int, sm_count: int) -> tuple[int, int]:
    """(nsplit, tiles per split) for a cache of ``n_tiles`` tiles under a
    grid of ``ctas`` CTAs per split: about ``CTAS_PER_SM`` CTAs per SM in
    all, never more splits than tiles, and the tiles shared out as evenly
    as whole splits allow."""
    want = max(1, -(-CTAS_PER_SM * sm_count // ctas))
    per = -(-n_tiles // min(want, n_tiles))
    return -(-n_tiles // per), per


def decode_attention(q, k, v, lengths, *, softcap=None, block_k=256):
    """q: (B, H, hd); k, v: (B, Smax, Hk, hd); lengths: (B,) int32 in
    ``[0, Smax]``.  Returns (B, H, hd) in q's dtype; ``Smax`` need not
    divide ``block_k``, and a row with ``length == 0`` gives zeros."""
    if q.ndim != 3 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"expected q (B,H,hd) and k, v (B,Smax,Hk,hd), "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, H, hd = q.shape
    if k.shape[0] != B or k.shape[3] != hd or H % k.shape[2]:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)} (H must be a multiple of Hk)")
    if tuple(lengths.shape) != (B,):
        raise ValueError(f"lengths must be ({B},), got "
                         f"{tuple(lengths.shape)}")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"softcap must be > 0, got {softcap}")
    if block_k < 1:
        raise ValueError(f"block_k must be >= 1, got {block_k}")
    if q.device.type in ("cpu", "meta"):
        return decode_attention_ref(q, k, v, lengths, softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    return _launch(q, k, v, lengths, softcap, block_k)


def _launch(q, k, v, lengths, softcap, block_k):
    global launches
    if q.dtype not in _build.DTYPE_CODES or k.dtype != q.dtype or \
            v.dtype != q.dtype or lengths.dtype != torch.int32:
        raise ValueError(f"decode_attention kernel takes float32 or bfloat16 "
                         f"q, k, v of one dtype and int32 lengths, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}, {lengths.dtype}")
    if not (k.device == q.device == v.device == lengths.device):
        raise ValueError("q, k, v, lengths must be on one device")
    B, H, hd = q.shape
    Smax, Hk = k.shape[1], k.shape[2]
    esize = q.element_size()
    if hd > THREADS or (hd * esize) % 16:
        raise ValueError(f"decode_attention kernel takes head_dim <= "
                         f"{THREADS} whose rows are whole 16-byte pieces, "
                         f"got {hd} in {q.dtype}")
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    for name, t in (("k", k), ("v", v)):
        if t.data_ptr() % 16 or any(t.stride(i) * esize % 16
                                    for i in range(3)):
            raise ValueError(f"decode_attention kernel reads {name} rows "
                             f"as 16-byte pieces: its storage and strides "
                             f"{t.stride()} must be 16-byte aligned")
    bk = min(block_k, Smax)
    nbytes = smem_bytes({"block_k": bk}, (q.shape, k.shape), q.dtype)
    limit = card_smem_limit(q.device)
    if nbytes > limit:
        raise ValueError(f"decode_attention block_k={block_k} at head_dim "
                         f"{hd} in {q.dtype} needs {nbytes} B of shared "
                         f"memory; the card allows {limit} B")
    gp = group_pad(H // Hk)
    groups = Hk * -(-(H // Hk) // gp)
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    nsplit, per = num_splits(B * groups, -(-Smax // bk), sms)
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    ws = torch.empty(B * groups * nsplit * gp * (hd + 2),
                     dtype=torch.float32, device=q.device)
    lengths = lengths.contiguous()
    lib = _build.library("decode_attention")
    code = lib.da_forward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
        o.data_ptr(), ws.data_ptr(), _build.DTYPE_CODES[q.dtype], B, Smax,
        H, Hk, hd, _build.strides(q, k, v, o), bk, per, nsplit,
        float(softcap or 0.0), nbytes,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check("decode_attention", code)
    launches += 1
    return o
