"""Decode attention (one new token against a KV cache): the port of the TPU
kernel to Hopper.

:func:`decode_attention` launches ``csrc/decode_attention.cu`` for CUDA
tensors, the tensor-core kernel for bf16 and the SIMT kernel for fp32, and
takes the plain PyTorch version (:func:`.ref.decode_attention_ref`) for
tensors on the CPU or on ``meta`` (shape tracing).  On a CUDA tensor it
launches a kernel or raises; it never falls back.  ``launches`` counts
calls that launched the kernel: a call launches a pass over the split
cache and, when the cache is split, a pass that combines the splits, and
counts once.

``lengths`` must lie in ``[0, Smax]``.  The launch path never reads them
back to the host (that would synchronise every call); the kernel clamps
them into that range, which is what the plain version's mask does with
values outside it.
"""

from __future__ import annotations

import ctypes
import functools
import re

import torch

from . import _build
from .ref import decode_attention_ref
from .substrate import card_smem_limit

launches = 0

THREADS = 256           # csrc/decode_attention.cu kThreads (fp32 route)
WARPS = THREADS // 32
MMA_HEAD_DIMS = (32, 64, 128, 256)   # head_dims of the bf16 route
TILE_ROWS = 64          # cache rows of a ring stage (bf16 route)
GROUP_ROWS = 16         # query heads of one m16 tile (bf16 route)


def group_pad(G: int) -> int:
    """Query heads one CTA of the fp32 route carries for a group of ``G``:
    G rounded up to 1, 2, 4 or 8 (larger groups are cut into pieces of
    8).  The bf16 route carries up to 16 in one m16 tile."""
    return 1 if G <= 1 else 2 if G <= 2 else 4 if G <= 4 else 8


def mma_instances(per_kernel: dict) -> dict[int, object]:
    """A per-kernel report of ``libdecode_attention.so`` (mangled name ->
    value, as :func:`._build.ptxas_report` gives it) reduced to its bf16
    tensor-core instances ``da_mma_kernel<hd>``, by head_dim."""
    return {int(m.group(1)): value for name, value in per_kernel.items()
            if (m := re.search(r"da_mma_kernelILi(\d+)E", name))}


def ring_stages(block_k: int) -> int:
    """Stages of the bf16 route's ring: ``block_k`` rows in flight beside
    the 64-row stage being multiplied, and at least 3."""
    return max(3, -(-block_k // TILE_ROWS) + 1)


def _align16(n: int) -> int:
    return -(-n // 16) * 16


def smem_bytes(params: dict, shapes, dtype: torch.dtype) -> int:
    """Dynamic shared memory of one CTA for ``params`` = {block_k} at
    ``shapes`` = (q shape, k shape) in ``dtype``; mirrors
    ``csrc/decode_attention.cu``: in bf16 ``da_mma_smem`` (the 16-row query
    tile and the ring of k and v tiles, rows padded to hd + 8), in fp32
    ``da_layout`` (the k and v tiles, fp32 scores, q group, reduction slots
    and row-group accumulators)."""
    q_shape, k_shape = shapes[0], shapes[1]
    H, hd = q_shape[1], q_shape[2]
    Smax, Hk = k_shape[1], k_shape[2]
    bk = min(params["block_k"], Smax)
    if dtype == torch.bfloat16:
        return 2 * (hd + 8) * (GROUP_ROWS + 2 * TILE_ROWS * ring_stages(bk))
    gp = group_pad(H // Hk)
    tile = _align16(bk * hd * dtype.itemsize)
    return (2 * tile + _align16(bk * gp * 4) + _align16(gp * hd * 4)
            + _align16(2 * WARPS * gp * 4) + (THREADS // hd) * gp * hd * 4)


def num_splits(ctas: int, n_tiles: int, sm_count: int,
               ctas_per_sm: int) -> tuple[int, int]:
    """(nsplit, tiles per split) for a cache of ``n_tiles`` tiles under a
    grid of ``ctas`` CTAs per split: as many splits as one wave of resident
    CTAs (``ctas_per_sm`` on each of ``sm_count`` SMs) holds, at least one,
    never more than tiles, and the tiles shared out as evenly as whole
    splits allow."""
    want = max(1, ctas_per_sm * sm_count // ctas)
    per = -(-n_tiles // min(want, n_tiles))
    return -(-n_tiles // per), per


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _ctas_per_sm(index: int, dtype: torch.dtype, H: int, Hk: int, hd: int,
                 bk: int, nbytes: int) -> int:
    out = ctypes.c_int(0)
    with torch.cuda.device(index):
        code = _build.library("decode_attention").da_occupancy(
            _build.DTYPE_CODES[dtype], H, Hk, hd, bk, nbytes,
            ctypes.byref(out))
    _build.check("decode_attention", code)
    if out.value < 1:
        raise RuntimeError(f"decode_attention: no CTA of {nbytes} B fits an "
                           f"SM")
    return out.value


@functools.lru_cache(maxsize=None)
def _plan(device: torch.device, dtype: torch.dtype, B: int, Smax: int, H: int,
          Hk: int, hd: int, block_k: int) -> dict:
    bk = min(block_k, Smax)
    nbytes = smem_bytes({"block_k": bk}, ((B, H, hd), (B, Smax, Hk, hd)),
                        dtype)
    limit = card_smem_limit(device)
    if nbytes > limit:
        raise ValueError(f"decode_attention block_k={block_k} at head_dim "
                         f"{hd} in {dtype} needs {nbytes} B of shared "
                         f"memory; the card allows {limit} B")
    G = H // Hk
    rows = GROUP_ROWS if dtype == torch.bfloat16 else group_pad(G)
    groups = Hk * -(-G // rows)
    tile = TILE_ROWS if dtype == torch.bfloat16 else bk
    per_sm = _ctas_per_sm(device.index, dtype, H, Hk, hd, bk, nbytes)
    nsplit, per = num_splits(B * groups, -(-Smax // tile),
                             _sm_count(device.index), per_sm)
    # the bf16 route writes o itself when the cache is not split
    ws = 0 if dtype == torch.bfloat16 and nsplit == 1 else \
        B * groups * nsplit * rows * (hd + 2)
    return dict(block_k=bk, smem_bytes=nbytes, ctas_per_sm=per_sm,
                nsplit=nsplit, tiles_per_split=per, workspace_floats=ws)


def split_plan(q, k, block_k: int = 256) -> dict:
    """How a launch on CUDA tensors ``q``, ``k`` splits the cache: the
    ``block_k`` it uses, its shared memory per CTA, the CTAs per SM the
    card can hold at that footprint, ``nsplit``, the tiles per split and
    the fp32 workspace (floats).  Cached per shape, dtype and device."""
    dev = q.device
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return _plan(dev, q.dtype, q.shape[0], k.shape[1], q.shape[1],
                 k.shape[2], q.shape[2], block_k)


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
    if q.dtype == torch.bfloat16:
        if hd not in MMA_HEAD_DIMS:
            raise ValueError(f"decode_attention's bf16 kernel takes head_dim "
                             f"in {MMA_HEAD_DIMS}, got {hd}")
    elif hd > THREADS or (hd * esize) % 16:
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
    plan = split_plan(q, k, block_k)
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    ws = torch.empty(plan["workspace_floats"], dtype=torch.float32,
                     device=q.device) if plan["workspace_floats"] else None
    lengths = lengths.contiguous()
    code = _build.library("decode_attention").da_forward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
        o.data_ptr(), None if ws is None else ws.data_ptr(),
        _build.DTYPE_CODES[q.dtype], B, Smax,
        H, Hk, hd, _build.strides(q, k, v, o), plan["block_k"],
        plan["tiles_per_split"], plan["nsplit"], float(softcap or 0.0),
        plan["smem_bytes"], torch.cuda.current_stream(q.device).cuda_stream)
    _build.check("decode_attention", code)
    launches += 1
    return o
