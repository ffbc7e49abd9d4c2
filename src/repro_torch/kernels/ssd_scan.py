"""Mamba-2 SSD chunked scan: the port of the TPU kernel to Hopper.

Replaces ``src/repro/kernels/ssd_scan.py`` (``_kernel`` :25, the wrapper
:71, ``pl.pallas_call`` :93).  :func:`ssd_scan` launches
``csrc/ssd_scan.cu`` for CUDA tensors and takes the plain PyTorch version
(:func:`.ref.ssd_ref`) for tensors on the CPU or on ``meta`` (shape
tracing).  On a CUDA tensor it launches a kernel or raises; it never falls
back.  Three routes:

* bf16 at P <= 128 and N <= 64 (Mamba-2's heads): three chunk-parallel
  ``mma.sync`` passes, the chunk states handed on through an fp32
  workspace that ``ssd_state_pass`` chains;
* bf16 at wider heads (up to 384, chunk <= 128: the mLSTM's): two
  warp-specialised passes on ``wgmma`` fed by TMA.  ``ssd_wide_state``
  walks the chunks in order per 64 x 128 tile of the state, the running
  state in registers as the TPU kernel keeps it in VMEM, and writes each
  chunk's incoming state once, as a high and a low bf16 part (the bytes
  of fp32, and about its precision); ``ssd_wide_scan`` reads it once per
  (chunk, 192-wide P tile) beside c, b and x, so the states cross memory
  twice.  It is bound by bytes: x, b, c, y and the final state, 27.6 MB
  (8.2 us at 3.35 TB/s) at (1, 2048, 4, 384), plus the 35.4 MB the
  states take each way;
* fp32: the SIMT kernel, one CTA per (batch, head) walking the chunks.

b and c may hold one map per head, one shared by all heads (a stride-0
view), or one per group of H / G heads, (B, S, G, N): the narrow and fp32
routes read head h's map at group h // (H / G), so no per-head copy is
made; the wide route takes them copied to the heads.  A sequence that is
no multiple of the chunk is padded in the last chunk with steps that leave
the state as it is, and their outputs are dropped: each call counts them
under the ``ssd_pad_positions`` counter of :mod:`..tracing`.

The ``ssd_scan_launches`` counter of :mod:`..tracing` counts calls that
launched a kernel (a route's passes count once);
``ssd_scan_wide_launches`` counts those of them that took the wide route.

The kernel has no backward.  When gradients are asked for (grad mode on
and an input that requires grad), a CUDA call goes through
:class:`.substrate.KernelFunction`, whose backward differentiates the plain
version recomputed from the saved inputs
(``ssd_scan_backward_launches``).  Each call is a ``kernel.ssd_scan`` span
of :mod:`..tracing` (``groups``, and ``pad``: the padded positions of the
last chunk), each backward a ``kernel.ssd_scan.backward`` span with CUDA
events.

:func:`ssd_decode` is the one-token step a decode takes, the second entry
point of ``csrc/ssd_scan.cu`` (no TPU kernel: the reference's
``ssd_decode_step`` is plain ``jnp``).  It reads each fp32 state once and
writes it once, into ``out`` when given, which may be the state itself
(the decode hands it the cache's slice, so the step updates the pool in
place); b and c are read by group, as here.  Its plain version is
:func:`.ref.ssd_decode_ref`.  The ``ssd_decode_launches`` counter of
:mod:`..tracing` counts its launches (eager calls and CUDA-graph
captures).
"""

from __future__ import annotations

import re

import torch

from .. import tracing
from . import _build, sharded
from .ref import heads_of, ssd_decode_ref, ssd_ref
from .substrate import KernelFunction, card_smem_limit

MAX_CHUNK = 256         # bf16 route: csrc/ssd_scan.cu kMaxChunk
# bf16 route up to 8 * kMaxPT and 16 * kMaxNK; beyond, the wide route
# (P and N up to kMaxWidth, chunk up to kWideMaxChunk)
NARROW_P, NARROW_N = 128, 64
MAX_P = MAX_N = 384
MAX_WIDE_CHUNK = 128
CHUNK_ALIGN = 16        # bf16 route: a chunk is whole m16 tiles
# the wide route (csrc/ssd_scan.cu): TMA boxes of WIDE_BOX bf16 columns
# (one 128-byte swizzled row) by MAX_WIDE_CHUNK rows, S_in boxes of
# WIDE_BOX rows; ssd_wide_state's state tiles WIDE_BOX rows by
# STATE_TP columns, ssd_wide_scan's output tiles SCAN_TP columns; the ring
# stages of ssd_wide_state's b and x and of ssd_wide_scan; the shared
# memory kept for barriers, weights and seg; the slack that aligns the
# tiles to 1024 bytes
WIDE_BOX = 64
STATE_TP, SCAN_TP = 2 * WIDE_BOX, 3 * WIDE_BOX
STATE_B_STAGES, STATE_X_STAGES, SCAN_STAGES = 3, 2, 2
WIDE_SMALL, WIDE_ALIGN = 2048, 1024
# the decode kernel (csrc/ssd_scan.cu ssd_decode): a CTA covers up to
# DECODE_MAX_TILE columns of P, fewer (down to DECODE_MIN_TILE, a 128-byte
# line a row) while the grid would hold fewer than DECODE_MIN_CTAS, two
# for each of the H100's 132 SMs
DECODE_MAX_TILE, DECODE_MIN_TILE, DECODE_MIN_CTAS = 128, 32, 264


def wide(P: int, N: int) -> bool:
    """Whether a bf16 launch at widths P, N takes the wide route
    (``ssd_wide_state`` then ``ssd_wide_scan``, on wgmma)."""
    return P > NARROW_P or N > NARROW_N


def mma_tiles(P: int, N: int = 0) -> int:
    """The n8 tiles of P the bf16 instance a launch at widths ``P``, ``N``
    runs holds (``launch_chunked_p`` in ``csrc/ssd_scan.cu``); on the wide
    route those of ``ssd_wide_scan``'s output tile, fixed by its code."""
    Pp = _round16(P)
    if wide(P, N):
        return SCAN_TP // 8
    return 4 if Pp <= 32 else 8 if Pp <= 64 else 10 if Pp <= 80 else 16


# the bf16 tensor-core passes by route: mma.sync (SASS HMMA) on the narrow
# one, wgmma (SASS HGMMA) on the wide one
NARROW_PASSES = ("ssd_chunk_state", "ssd_chunk_scan")
WIDE_PASSES = ("ssd_wide_state", "ssd_wide_scan")


def mma_opcode(pass_name: str) -> str:
    """The SASS opcode of a tensor-core pass's products."""
    return "HGMMA" if pass_name in WIDE_PASSES else "HMMA"


def mma_passes(per_kernel: dict, P: int | None = None,
               la_dtype: torch.dtype | None = None,
               N: int = 0) -> dict[str, list]:
    """A per-kernel report of ``libssd_scan.so`` (mangled name -> value, as
    :func:`._build.ptxas_report` gives it) reduced to the bf16 route's
    tensor-core passes, :data:`NARROW_PASSES` and :data:`WIDE_PASSES`,
    each with its instances (per ``log_a`` dtype and P's n8 tiles), or
    only the instances a launch at widths ``P``, ``N`` with ``log_a`` in
    ``la_dtype`` runs."""
    la = {None: r"\w+?", torch.float32: "f",
          torch.bfloat16: "13__nv_bfloat16"}[la_dtype]
    names = NARROW_PASSES + WIDE_PASSES if P is None else \
        WIDE_PASSES if wide(P, N) else NARROW_PASSES
    out: dict[str, list] = {}
    for name, value in per_kernel.items():
        # the narrow instances also by P's n8 tiles (Li<tiles>E)
        m = re.search(rf"\d({'|'.join(names)})I{la}(?:Li(\d+))?E", name)
        if m and (P is None or m.group(1) in WIDE_PASSES or
                  m.group(2) == str(mma_tiles(P, N))):
            out.setdefault(m.group(1), []).append(value)
    return out


def _round16(n: int) -> int:
    return -(-n // 16) * 16


def chunk_length(chunk: int, S: int, dtype: torch.dtype) -> int:
    """The chunk length a launch uses: ``min(chunk, S)``, rounded up to a
    multiple of ``CHUNK_ALIGN`` (whole m16 tiles) in bf16; steps past S are
    padding."""
    L = min(chunk, S)
    return -(-L // CHUNK_ALIGN) * CHUNK_ALIGN if dtype == torch.bfloat16 \
        else L


def smem_parts(params: dict, shapes, dtype: torch.dtype) -> dict[str, int]:
    """Dynamic shared memory of one CTA for ``params`` = {chunk} at
    ``shapes`` = (x shape, b shape) with x in ``dtype``, term by term;
    mirrors ``csrc/ssd_scan.cu``: in bf16 ``chunked_smem``, the terms of
    the larger of its passes (narrow: chunk-state and chunk-scan, bf16 rows
    padded to a multiple of 16 plus 8; wide, whatever the chunk:
    ``ssd_wide_state``'s rings of b's and x's boxes, its two staged
    (b w)^T tiles and the S_in tile it stores, ``ssd_wide_scan``'s x boxes
    and ring of c, b and S_in boxes, S_in in a high and a low bf16 part
    in both; a box is 128 rows of 128 bytes, 64
    rows for a 64-row tile; the two passes take the same bytes, and the
    terms are ``ssd_wide_state``'s), in fp32 ``ssd_smem_floats``."""
    x_shape, b_shape = shapes[0], shapes[1]
    S, P, N = x_shape[1], x_shape[3], b_shape[3]
    L = chunk_length(params["chunk"], S, dtype)
    if dtype == torch.bfloat16 and wide(P, N):
        box = MAX_WIDE_CHUNK * 2 * WIDE_BOX
        sbox = WIDE_BOX * 2 * WIDE_BOX
        state = {"state b": STATE_B_STAGES * box,
                 "state x": STATE_X_STAGES * 2 * box,
                 "state (b w)^T, high and low, twice": 2 * 4 * sbox,
                 "state S_in out, high and low": 2 * 2 * sbox,
                 "state barriers, weights": WIDE_SMALL,
                 "state alignment": WIDE_ALIGN}
        scan = {"scan x": 3 * box, "scan c": SCAN_STAGES * box,
                "scan b": SCAN_STAGES * box,
                "scan S_in, high and low": SCAN_STAGES * 2 * 3 * sbox,
                "scan barriers, seg": WIDE_SMALL,
                "scan alignment": WIDE_ALIGN}
        return max(state, scan, key=lambda p: sum(p.values()))
    if dtype == torch.bfloat16:
        Pp, Np = _round16(P), _round16(N)
        sx, sn = Pp + 8, Np + 8
        state = {"state x": 2 * L * sx, "state seg": 4 * L,
                 "state b": 2 * L * sn}
        scan = {"scan x": 2 * L * sx, "scan S_in": 4 * Np * sx,
                "scan seg": 8 * L, "scan b": 2 * L * sn,
                "scan c": 2 * L * sn}
        return max(state, scan, key=lambda p: sum(p.values()))
    return {"x": 4 * L * P, "b, c": 4 * 2 * L * (N + 1), "scores": 4 * L * L,
            "state": 4 * N * P, "seg": 4 * 3 * L}


def smem_bytes(params: dict, shapes, dtype: torch.dtype) -> int:
    """The total of :func:`smem_parts`: the figure a launch hands the
    kernel, which refuses any other."""
    return sum(smem_parts(params, shapes, dtype).values())


def check_launch(params: dict, shapes, dtype: torch.dtype,
                 limit: int | None = None) -> str | None:
    """Why a launch at ``params`` = {chunk} on ``shapes`` = (x shape, b
    shape) with x in ``dtype`` would be refused, or None; ``limit`` is the
    card's shared memory per block (None: not checked)."""
    x_shape, b_shape = shapes[0], shapes[1]
    S, P, N = x_shape[1], x_shape[3], b_shape[3]
    chunk = params["chunk"]
    if dtype not in _build.DTYPE_CODES:
        return f"ssd_scan kernel takes float32 or bfloat16 x, got {dtype}"
    L = chunk_length(chunk, S, dtype)
    if dtype == torch.bfloat16 and (
            L > MAX_CHUNK or P > MAX_P or N > MAX_N or
            (wide(P, N) and L > MAX_WIDE_CHUNK)):
        return (f"ssd_scan's bf16 kernel takes chunk <= {MAX_CHUNK} with P "
                f"<= {NARROW_P} and N <= {NARROW_N}, or chunk <= "
                f"{MAX_WIDE_CHUNK} with P and N <= {MAX_P}, got "
                f"chunk={chunk}, P={P}, N={N}")
    nbytes = smem_bytes(params, shapes, dtype)
    if limit is not None and nbytes > limit:
        route = "fp32" if dtype == torch.float32 else "bf16"
        return (f"ssd_scan's {route} kernel at chunk={chunk}, P={P}, N={N} "
                f"needs {nbytes} B of shared memory; the card allows "
                f"{limit} B")
    return None


def workspace_bytes(params: dict, shapes, dtype: torch.dtype) -> int:
    """Device memory of the workspace a call allocates: on the narrow bf16
    route the (B, H, nc, N, P) fp32 chunk states and (B, H, nc) decays the
    passes hand on; on the wide one the states that enter chunks 1 ..
    nc - 1 as high and low bf16 parts, (B, H, nc - 1, 2, N, Pw) (Pw: P
    rounded up to 8, TMA's 16-byte rows); the fp32 route needs none."""
    if dtype != torch.bfloat16:
        return 0
    x_shape, b_shape = shapes[0], shapes[1]
    B, S, H, P = x_shape
    N = b_shape[3]
    nc = -(-S // chunk_length(params["chunk"], S, dtype))
    if wide(P, N):
        return 2 * B * H * (nc - 1) * 2 * N * -(-P // 8) * 8
    return 4 * B * H * nc * (N * P + 1)


def tma_ready(t: torch.Tensor) -> torch.Tensor:
    """``t`` (B, S, H, width) in bf16 as the wide route's TMA reads it: a
    16-byte aligned start and strides of multiples of 8 elements (0 for a
    broadcast head or batch), the last axis contiguous; else a copy into
    rows padded to a multiple of 8, viewed at ``t``'s width."""
    st = t.stride()
    if st[3] == 1 and t.data_ptr() % 16 == 0 and st[1] > 0 and \
            all(s % 8 == 0 for s in st[:3]):
        return t
    width = t.shape[3]
    buf = torch.empty((*t.shape[:3], -(-width // 8) * 8), dtype=t.dtype,
                      device=t.device)
    view = buf[..., :width]
    view.copy_(t)
    return view


def ssd_scan(x, log_a, b, c, *, chunk=128):
    """x: (B, S, H, P); log_a: (B, S, H); b, c: (B, S, G, N), G = H, or G
    dividing H: head h reads group h // (H / G).

    Returns (y: (B, S, H, P) in x's dtype, final_state: (B, H, N, P) fp32).
    ``S`` need not divide the chunk length.
    """
    with tracing.span("kernel.ssd_scan") as sp:
        if x.ndim != 4 or log_a.shape != x.shape[:3] or b.ndim != 4 or \
                b.shape != c.shape or b.shape[:2] != x.shape[:2] or \
                x.shape[2] % b.shape[2]:
            raise ValueError(f"expected x (B,S,H,P), log_a (B,S,H), b, c "
                             f"(B,S,G,N) with G dividing H, got "
                             f"{tuple(x.shape)}, {tuple(log_a.shape)}, "
                             f"{tuple(b.shape)}, {tuple(c.shape)}")
        if chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {chunk}")
        # the padded steps of the last chunk: of the kernel's chunk length
        # on the card, of min(chunk, S) in the plain version
        S = x.shape[1]
        pad = -S % (chunk_length(chunk, S, x.dtype) if x.is_cuda
                    else min(chunk, S))
        sp.set(groups=b.shape[2], pad=pad)
        tracing.count("ssd_pad_positions", pad)
        if sharded.is_dtensor(x):
            return sharded.ssd_scan(ssd_scan, x, log_a, b, c, chunk=chunk)
        if x.device.type in ("cpu", "meta"):
            return ssd_ref(x, log_a, b, c, chunk=chunk)
        if x.device.type != "cuda":
            raise ValueError(f"ssd_scan: unsupported device {x.device}")
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in (x, log_a, b, c)):
            return KernelFunction.apply(
                "ssd_scan", lambda *t: _launch(*t, chunk),
                lambda *t: ssd_ref(*t, chunk=chunk), x, log_a, b, c)
        return _launch(x, log_a, b, c, chunk)


def _launch(x, log_a, b, c, chunk):
    if x.dtype not in _build.DTYPE_CODES or b.dtype != x.dtype or \
            c.dtype != x.dtype or log_a.dtype not in _build.DTYPE_CODES:
        raise ValueError(f"ssd_scan kernel takes float32 or bfloat16 x, b, c "
                         f"of one dtype and a float32 or bfloat16 log_a, got "
                         f"{x.dtype}, {b.dtype}, {c.dtype}, {log_a.dtype}")
    if not (log_a.device == b.device == c.device == x.device):
        raise ValueError("x, log_a, b, c must be on one device")
    B, S, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    shapes = (x.shape, b.shape)
    reason = check_launch({"chunk": chunk}, shapes, x.dtype,
                          card_smem_limit(x.device))
    if reason:
        raise ValueError(reason)
    L = chunk_length(chunk, S, x.dtype)
    params = {"chunk": L}
    nbytes = smem_bytes(params, shapes, x.dtype)
    is_wide = x.dtype == torch.bfloat16 and wide(P, N)
    if is_wide:
        if G != H:      # the wide route's maps hold one map a head
            b, c, G = (b.repeat_interleave(H // G, dim=2),
                       c.repeat_interleave(H // G, dim=2), H)
        x, b, c = (tma_ready(t) for t in (x, b, c))
    else:
        x, b, c = (t if t.stride(-1) == 1 else t.contiguous()
                   for t in (x, b, c))
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    fin = torch.empty((B, H, N, P), dtype=torch.float32, device=x.device)
    ws = torch.empty(workspace_bytes(params, shapes, x.dtype) // 4,
                     dtype=torch.float32, device=x.device)
    code = _build.library("ssd_scan").ssd_forward(
        x.data_ptr(), log_a.data_ptr(), b.data_ptr(), c.data_ptr(),
        y.data_ptr(), fin.data_ptr(), ws.data_ptr(),
        _build.DTYPE_CODES[x.dtype], _build.DTYPE_CODES[log_a.dtype], B, S,
        H, P, N, H // G, _build.strides(x, log_a, b, c, y), L, nbytes,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check("ssd_scan", code)
    tracing.count("ssd_scan_launches")
    if is_wide:
        tracing.count("ssd_scan_wide_launches")
    return y, fin


def decode_tile(B: int, H: int, P: int) -> int:
    """The columns of P one CTA of the decode kernel covers at (B, H, P):
    all of P up to ``DECODE_MAX_TILE``, halved while the grid of B x H x
    tiles holds fewer than ``DECODE_MIN_CTAS`` and half stays a multiple
    of 4 of at least ``DECODE_MIN_TILE`` (at N = P = 64 a CTA takes a
    head; at the mLSTM's P = 384 over 4 rows of 4 heads, 32 columns)."""
    tile = min(P, DECODE_MAX_TILE)
    while tile // 2 >= DECODE_MIN_TILE and tile % 8 == 0 and \
            B * H * -(-P // tile) < DECODE_MIN_CTAS:
        tile //= 2
    return tile


def ssd_decode(state, x, log_a, b, c, *, out=None):
    """One token of the recurrence.  state: (B, H, N, P) fp32; x: (B, 1, H,
    P); log_a: (B, 1, H); b, c: (B, 1, G, N), G dividing H: head h reads
    group h // (H / G).

    Returns (y: (B, 1, H, P) in x's dtype, the new state (B, H, N, P)
    fp32), ``st = state * exp(log_a) + b xᵀ`` and ``y = c · st``.  The new
    state is written into ``out`` when given (a contiguous fp32 tensor of
    the state's shape, which may be ``state`` itself) and ``out`` is
    returned; without it the state is left as it is."""
    if state.ndim != 4 or x.ndim != 4 or x.shape[1] != 1 or \
            tuple(state.shape) != (x.shape[0], x.shape[2],
                                   b.shape[-1], x.shape[3]) or \
            tuple(log_a.shape) != tuple(x.shape[:3]) or b.ndim != 4 or \
            b.shape != c.shape or b.shape[:2] != x.shape[:2] or \
            x.shape[2] % b.shape[2]:
        raise ValueError(f"expected state (B,H,N,P), x (B,1,H,P), log_a "
                         f"(B,1,H), b, c (B,1,G,N) with G dividing H, "
                         f"got {tuple(state.shape)}, {tuple(x.shape)}, "
                         f"{tuple(log_a.shape)}, {tuple(b.shape)}, "
                         f"{tuple(c.shape)}")
    if out is not None and (out.shape != state.shape or
                            out.dtype != torch.float32 or
                            out.device != state.device):
        raise ValueError(f"out must be a float32 tensor of shape "
                         f"{tuple(state.shape)} on {state.device}, got "
                         f"{out.dtype} {tuple(out.shape)} on "
                         f"{out.device}")
    if sharded.is_dtensor(x):
        H = x.shape[2]
        y, st = sharded.ssd_decode(ssd_decode, state, x, log_a,
                                   heads_of(b, H), heads_of(c, H))
    elif x.device.type in ("cpu", "meta"):
        y, st = ssd_decode_ref(state, x, log_a, b, c)
    elif x.device.type != "cuda":
        raise ValueError(f"ssd_decode: unsupported device {x.device}")
    else:
        return _decode_launch(state, x, log_a, b, c, out)
    if out is None:
        return y, st
    return y, out.copy_(st)


def _aligned(t) -> bool:
    """Whether the decode kernel reads or writes ``t`` as it is: contiguous
    and 16-byte aligned."""
    return t.is_contiguous() and t.data_ptr() % 16 == 0


def _decode_launch(state, x, log_a, b, c, out):
    if x.dtype not in _build.DTYPE_CODES or b.dtype != x.dtype or \
            c.dtype != x.dtype or state.dtype != torch.float32:
        raise ValueError(f"ssd_decode kernel takes a float32 state and "
                         f"float32 or bfloat16 x, b, c of one dtype, got "
                         f"{state.dtype}, {x.dtype}, {b.dtype}, {c.dtype}")
    if not (state.device == x.device == log_a.device == b.device ==
            c.device):
        raise ValueError("state, x, log_a, b, c must be on one device")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (state, x, log_a, b, c)):
        # the kernel has no backward and decode never trains
        raise ValueError("ssd_decode takes no input that requires grad while "
                         "grad mode is on: the kernel has no backward (run "
                         "decode under torch.no_grad())")
    B, H, N, P = state.shape
    if P % 4:
        raise ValueError(f"ssd_decode kernel reads the state 4 columns at a "
                         f"time: P must be a multiple of 4, got {P}")
    if out is None:
        out = torch.empty(state.shape, dtype=torch.float32,
                          device=state.device)
    elif not _aligned(out):
        raise ValueError(f"ssd_decode kernel writes out as it is: it must be "
                         f"contiguous and 16-byte aligned, got strides "
                         f"{out.stride()}")
    if not _aligned(state):
        state = state.contiguous()
    x, b, c = (t if t.stride(-1) == 1 else t.contiguous() for t in (x, b, c))
    log_a = log_a.float()
    y = torch.empty((B, 1, H, P), dtype=x.dtype, device=x.device)
    code = _build.library("ssd_scan").ssd_decode(
        state.data_ptr(), x.data_ptr(), log_a.data_ptr(), b.data_ptr(),
        c.data_ptr(), out.data_ptr(), y.data_ptr(),
        _build.DTYPE_CODES[x.dtype], B, H, N, P, H // b.shape[2],
        _build.strides(state, x[:, 0], log_a[:, 0], b[:, 0], c[:, 0], out,
                       y[:, 0], dims=2),
        decode_tile(B, H, P), torch.cuda.current_stream(x.device).cuda_stream)
    _build.check("ssd_scan", code)
    tracing.count("ssd_decode_launches")
    return y, out
