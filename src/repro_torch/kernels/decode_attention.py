"""Decode attention (one new token against a KV cache): the port of the TPU
kernel to Hopper.

:func:`decode_attention` launches ``csrc/decode_attention.cu`` for CUDA
tensors, the tensor-core kernel for bf16 and the SIMT kernel for fp32, and
takes the plain PyTorch version (:func:`.ref.decode_attention_ref`) for
tensors on the CPU or on ``meta`` (shape tracing).  On a CUDA tensor it
launches a kernel or raises; it never falls back.  The
``decode_attention_launches`` counter of :mod:`..tracing` counts calls
that launched the kernel: a call launches a pass over the split cache
and, when the cache is split, a pass that combines the splits, and counts
once.  Each call is a ``kernel.decode_attention`` span of
:mod:`..tracing`.

``lengths`` must lie in ``[0, Smax]``.  The launch path never reads them
back to the host (that would synchronise every call); the kernel clamps
them into that range, which is what the plain version's mask does with
values outside it.

``window`` goes beyond the TPU kernel: the models' sliding-window layers
mask decode to the last ``window`` keys (``kpos >= length - window``), and
the kernel skips the cache tiles wholly before them.

So do ``starts`` and ``return_lse``, which a cache split on its sequence
across ranks needs (``sharded.decode_attention``): ``starts`` masks the
keys before a per-row bound, and ``return_lse`` returns each row's
log-sum-exp beside the output, written by the kernel itself (by
``da_combine``, or by the bf16 kernel when the cache is not split), so
that :func:`.ref.combine_partials` can merge the slices' outputs.

``out`` is a buffer the output is written into, in place of a new
tensor: the decode step replayed as CUDA graphs
(``launch/steps.py``) hands each eager call the buffer its next graph
reads.
"""

from __future__ import annotations

import ctypes
import functools
import re

import torch

from .. import tracing
from . import _build, sharded
from .ref import decode_attention_ref
from .substrate import DEFAULT_PARAMS, card_smem_limit, serving_param

THREADS = 256           # csrc/decode_attention.cu kThreads (fp32 route)
WARPS = THREADS // 32
MMA_HEAD_DIMS = (32, 64, 80, 128, 224, 256)   # head_dims of the bf16 route
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


def smem_parts(params: dict, shapes, dtype: torch.dtype) -> dict[str, int]:
    """Dynamic shared memory of one CTA for ``params`` = {block_k} at
    ``shapes`` = (q shape, k shape) in ``dtype``, term by term; mirrors
    ``csrc/decode_attention.cu``: in bf16 ``da_mma_smem`` (the 16-row query
    tile and the ring of k and v tiles, rows padded to hd + 8), in fp32
    ``da_layout`` (the k and v tiles, fp32 scores, q group, reduction slots
    and row-group accumulators)."""
    q_shape, k_shape = shapes[0], shapes[1]
    H, hd = q_shape[1], q_shape[2]
    Smax, Hk = k_shape[1], k_shape[2]
    bk = min(params["block_k"], Smax)
    if dtype == torch.bfloat16:
        row = 2 * (hd + 8)
        ring = row * TILE_ROWS * ring_stages(bk)
        return {"q": row * GROUP_ROWS, "k": ring, "v": ring}
    gp = group_pad(H // Hk)
    tile = _align16(bk * hd * dtype.itemsize)
    return {"k": tile, "v": tile, "scores": _align16(bk * gp * 4),
            "q": _align16(gp * hd * 4),
            "reduction": _align16(2 * WARPS * gp * 4),
            "acc": (THREADS // hd) * gp * hd * 4}


def smem_bytes(params: dict, shapes, dtype: torch.dtype) -> int:
    """The total of :func:`smem_parts`: the figure a launch hands the
    kernel, which refuses any other."""
    return sum(smem_parts(params, shapes, dtype).values())


def check_launch(params: dict, shapes, dtype: torch.dtype,
                 limit: int | None = None) -> str | None:
    """Why a launch at ``params`` = {block_k} (as :func:`block_size` gives
    it) on ``shapes`` = (q shape, k shape) in ``dtype`` would be refused,
    or None; ``limit`` is the card's shared memory per block (None: not
    checked)."""
    hd = shapes[0][2]
    if dtype not in _build.DTYPE_CODES:
        return (f"decode_attention kernel takes float32 or bfloat16 q, k, "
                f"v, got {dtype}")
    if dtype == torch.bfloat16:
        if hd not in MMA_HEAD_DIMS:
            return (f"decode_attention's bf16 kernel takes head_dim in "
                    f"{MMA_HEAD_DIMS}, got {hd}")
    elif hd > THREADS or (hd * dtype.itemsize) % 16:
        return (f"decode_attention kernel takes head_dim <= {THREADS} "
                f"whose rows are whole 16-byte pieces, got {hd} in {dtype}")
    nbytes = smem_bytes(params, shapes, dtype)
    if limit is not None and nbytes > limit:
        return (f"decode_attention block_k={params['block_k']} at head_dim "
                f"{hd} in {dtype} needs {nbytes} B of shared memory; the "
                f"card allows {limit} B")
    return None


def window_tiles(n_tiles: int, tile: int, window: int | None) -> int:
    """The cache tiles of ``tile`` rows a row may touch: all ``n_tiles``,
    or with a ``window`` at most the ``ceil(window / tile) + 1`` tiles the
    window overlaps."""
    return n_tiles if not window else min(n_tiles, -(-window // tile) + 1)


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
          Hk: int, hd: int, block_k: int, window: int | None = None
          ) -> dict:
    bk = min(block_k, Smax)
    shapes = ((B, H, hd), (B, Smax, Hk, hd))
    reason = check_launch({"block_k": block_k}, shapes, dtype,
                          card_smem_limit(device))
    if reason:
        raise ValueError(reason)
    nbytes = smem_bytes({"block_k": bk}, shapes, dtype)
    G = H // Hk
    rows = GROUP_ROWS if dtype == torch.bfloat16 else group_pad(G)
    groups = Hk * -(-G // rows)
    tile = TILE_ROWS if dtype == torch.bfloat16 else bk
    per_sm = _ctas_per_sm(device.index, dtype, H, Hk, hd, bk, nbytes)
    nsplit, per = num_splits(B * groups,
                             window_tiles(-(-Smax // tile), tile, window),
                             _sm_count(device.index), per_sm)
    # the bf16 route writes o itself when the cache is not split
    ws = 0 if dtype == torch.bfloat16 and nsplit == 1 else \
        B * groups * nsplit * rows * (hd + 2)
    return dict(block_k=bk, smem_bytes=nbytes, ctas_per_sm=per_sm,
                nsplit=nsplit, tiles_per_split=per, workspace_floats=ws)


def block_size(q, k, block_k: int | None = None) -> int:
    """The ``block_k`` a launch on ``q``, ``k`` asks for.  A size given is
    used as it is (a launch refuses one whose tiles do not fit); None is the
    adopted tuned one (``substrate.serving_param``), else the default,
    halved while the card's shared memory cannot hold the ring at this
    head_dim and dtype: bf16 at head_dim 256 cannot hold 256."""
    if block_k is not None:
        return block_k
    bk = serving_param("decode_attention", "block_k",
                       DEFAULT_PARAMS["decode_attention"]["block_k"])
    limit = card_smem_limit(q.device)
    while limit is not None and bk > TILE_ROWS and smem_bytes(
            {"block_k": bk}, (q.shape, k.shape), q.dtype) > limit:
        bk //= 2
    return bk


def split_plan(q, k, block_k: int | None = None,
               window: int | None = None) -> dict:
    """How a launch on CUDA tensors ``q``, ``k`` splits the cache: the
    ``block_k`` it uses (:func:`block_size`), its shared memory per CTA,
    the CTAs per SM the card can hold at that footprint, ``nsplit``, the
    tiles per split and the fp32 workspace (floats).  With a ``window`` the
    splits cover the tiles a window touches.  Cached per shape, dtype,
    block_k, window and device."""
    dev = q.device
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return _plan(dev, q.dtype, q.shape[0], k.shape[1], q.shape[1],
                 k.shape[2], q.shape[2], block_size(q, k, block_k), window)


def decode_attention(q, k, v, lengths, *, softcap=None, window=None,
                     block_k=None, starts=None, return_lse=False, out=None):
    """q: (B, H, hd); k, v: (B, Smax, Hk, hd); lengths: (B,) int32 in
    ``[0, Smax]``; ``window``: keys at ``kpos < length - window`` are
    masked too; ``starts``: (B,) int32, keys at ``kpos < starts[b]`` are
    masked too.  Returns (B, H, hd) in q's dtype, and with ``return_lse``
    also each row's log-sum-exp, (B, H) fp32 (-inf for a row with no
    valid key); ``Smax`` need not divide ``block_k`` (None:
    :func:`block_size` chooses), and a row with no valid key gives
    zeros."""
    with tracing.span("kernel.decode_attention"):
        if q.ndim != 3 or k.ndim != 4 or k.shape != v.shape:
            raise ValueError(f"expected q (B,H,hd) and k, v (B,Smax,Hk,hd), "
                             f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                             f"{tuple(v.shape)}")
        B, H, hd = q.shape
        if k.shape[0] != B or k.shape[3] != hd or H % k.shape[2]:
            raise ValueError(f"k/v {tuple(k.shape)} do not match q "
                             f"{tuple(q.shape)} (H must be a multiple of Hk)")
        for name, t in (("lengths", lengths), ("starts", starts)):
            if t is not None and tuple(t.shape) != (B,):
                raise ValueError(f"{name} must be ({B},), got "
                                 f"{tuple(t.shape)}")
        if softcap is not None and softcap <= 0:
            raise ValueError(f"softcap must be > 0, got {softcap}")
        if window is not None and window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        if block_k is not None and block_k < 1:
            raise ValueError(f"block_k must be >= 1, got {block_k}")
        if out is not None and (tuple(out.shape) != (B, H, hd) or
                                out.dtype != q.dtype or
                                out.device != q.device or
                                not out.is_contiguous()):
            raise ValueError(f"out must be a contiguous {q.dtype} tensor of "
                             f"shape {tuple(q.shape)} on {q.device}, got "
                             f"{out.dtype} {tuple(out.shape)} on "
                             f"{out.device}")
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or
                                        v.requires_grad):
            # the kernel has no backward and decode never trains: a gradient
            # would stop here unseen on the card
            raise ValueError("decode_attention takes no input that requires "
                             "grad while grad mode is on: the kernel has no "
                             "backward (run decode under torch.no_grad())")
        if sharded.is_dtensor(q):
            if starts is not None or return_lse or out is not None:
                raise ValueError("decode_attention on DTensors takes no "
                                 "starts or out and returns no lse: it "
                                 "combines the slices of a split cache "
                                 "itself")
            return sharded.decode_attention(
                decode_attention, q, k, v, lengths, softcap=softcap,
                window=window, block_k=block_k)
        if q.device.type in ("cpu", "meta"):
            got = decode_attention_ref(q, k, v, lengths, softcap=softcap,
                                       window=window, starts=starts,
                                       return_lse=return_lse)
            if out is None:
                return got
            o, lse = got if return_lse else (got, None)
            out.copy_(o)
            return (out, lse) if return_lse else out
        if q.device.type != "cuda":
            raise ValueError(f"decode_attention: unsupported device "
                             f"{q.device}")
        return _launch(q, k, v, lengths, softcap, window, block_k, starts,
                       return_lse, out)


def _launch(q, k, v, lengths, softcap, window, block_k, starts=None,
            return_lse=False, out=None):
    if q.dtype not in _build.DTYPE_CODES or k.dtype != q.dtype or \
            v.dtype != q.dtype or lengths.dtype != torch.int32 or \
            (starts is not None and starts.dtype != torch.int32):
        raise ValueError(f"decode_attention kernel takes float32 or bfloat16 "
                         f"q, k, v of one dtype and int32 lengths and starts, "
                         f"got {q.dtype}, {k.dtype}, {v.dtype}, "
                         f"{lengths.dtype}"
                         + ("" if starts is None else f", {starts.dtype}"))
    if not (k.device == q.device == v.device == lengths.device) or \
            (starts is not None and starts.device != q.device):
        raise ValueError("q, k, v, lengths, starts must be on one device")
    B, H, hd = q.shape
    Smax, Hk = k.shape[1], k.shape[2]
    esize = q.element_size()
    reason = check_launch({"block_k": block_size(q, k, block_k)},
                          (q.shape, k.shape), q.dtype,
                          card_smem_limit(q.device))
    if reason:
        raise ValueError(reason)
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    for name, t in (("k", k), ("v", v)):
        if t.data_ptr() % 16 or any(t.stride(i) * esize % 16
                                    for i in range(3)):
            raise ValueError(f"decode_attention kernel reads {name} rows "
                             f"as 16-byte pieces: its storage and strides "
                             f"{t.stride()} must be 16-byte aligned")
    plan = split_plan(q, k, block_k, window)
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device) \
        if out is None else out
    ws = torch.empty(plan["workspace_floats"], dtype=torch.float32,
                     device=q.device) if plan["workspace_floats"] else None
    lse = torch.empty((B, H), dtype=torch.float32, device=q.device) \
        if return_lse else None
    lengths = lengths.contiguous()
    starts = None if starts is None else starts.contiguous()
    code = _build.library("decode_attention").da_forward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
        None if starts is None else starts.data_ptr(), o.data_ptr(),
        None if lse is None else lse.data_ptr(),
        None if ws is None else ws.data_ptr(),
        _build.DTYPE_CODES[q.dtype], B, Smax,
        H, Hk, hd, _build.strides(q, k, v, o), plan["block_k"],
        plan["tiles_per_split"], plan["nsplit"], float(softcap or 0.0),
        window or 0, plan["smem_bytes"],
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check("decode_attention", code)
    tracing.count("decode_attention_launches")
    return (o, lse) if return_lse else o
