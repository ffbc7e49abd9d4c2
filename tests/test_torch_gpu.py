"""The port's CUDA kernels against their plain PyTorch versions, and the CNN
zoo's layer forms against their CPU runs, on the card.

Marked ``gpu``: every test takes the ``cuda`` fixture, which skips where
``torch.cuda.is_available()`` is false (decided at run time, never at
import).  The file imports no JAX, so it runs on a GPU host that has none:

    PYTHONPATH=src python -m pytest tests/test_torch_gpu.py -m gpu

Inputs come from numpy with a seed.  Tolerances: fp32 2e-5 for attention
(prefill and decode) and 2e-4 for the SSD scan (its outputs sum hundreds of
terms of magnitude ~10), bf16 3e-2, as in tests/test_kernels.py; the plain
versions run in fp32 with TF32 off.  bf16 flash and decode attention run on
the tensor cores and round P to bf16 before the PV product (at most 2**-8
relative per term), which 3e-2 covers.  The bf16 SSD passes run on the
tensor cores too; they split every fp32 operand into two bf16 parts, so the
final state keeps the fp32 tolerance.
"""

import threading

import numpy as np
import pytest
import torch

from repro_torch.core import TensorSpec, fuse_blocks
from repro_torch.kernels import _build
from repro_torch.kernels import decode_attention as da_mod
from repro_torch.kernels import flash_attention as fa_mod
from repro_torch.kernels import ssd_scan as ssd_mod
from repro_torch.kernels.ref import (decode_attention_ref,
                                     flash_attention_ref, ssd_decode_ref,
                                     ssd_ref)
from repro_torch.kernels.substrate import card_smem_limit
from repro_torch.models import cnn_zoo
from repro_torch import tracing

pytestmark = pytest.mark.gpu

TOL = {torch.float32: dict(rtol=2e-5, atol=2e-5),
       torch.bfloat16: dict(rtol=3e-2, atol=3e-2)}
SSD_TOL = {torch.float32: dict(rtol=2e-4, atol=2e-4),
           torch.bfloat16: dict(rtol=3e-2, atol=3e-2)}
LAUNCHES = ("flash_attention_launches", "ssd_scan_launches",
            "decode_attention_launches")
TRAINED = ("flash_attention_launches", "ssd_scan_launches",
           "flash_attention_backward_launches", "ssd_scan_backward_launches")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _counts(*names: str) -> tuple[int, ...]:
    """The ``tracing`` counters' totals: tests take differences."""
    counts = tracing.counters()
    return tuple(counts[n] for n in names)


def _counted(name: str) -> int:
    return tracing.counters()[name]


def _randn(rng, shape, dtype, device):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)) \
        .to(device, dtype)


def _close(got, want, tol):
    torch.testing.assert_close(got.float(), want.float(), **tol)


FLASH_CASES = [  # B, Sq, Sk, H, Hk, hd, causal, window, softcap, bq, bk
    (1, 256, 256, 4, 4, 64, True, None, None, 128, 128),      # MHA
    (2, 256, 256, 8, 2, 64, True, None, None, 128, 128),      # GQA 4:1
    (1, 128, 128, 2, 2, 256, True, None, None, 32, 32),       # head_dim 256
    (1, 512, 512, 4, 2, 64, True, 200, None, 128, 64),        # window
    (1, 300, 300, 4, 2, 64, True, 70, 30.0, 128, 128),        # window+softcap
    (1, 200, 200, 4, 2, 64, False, None, None, 128, 128),     # uneven
    (1, 384, 200, 4, 2, 64, True, None, None, 128, 128),
    (1, 130, 257, 4, 2, 64, True, None, None, 64, 128),
    (1, 640, 640, 32, 32, 80, True, None, None, 128, 128),    # zamba2 heads
    (2, 4, 1500, 16, 16, 64, False, None, None, 128, 128),    # whisper cross
    (1, 1500, 1500, 16, 16, 64, False, None, None, 128, 128),  # its encoder
    (2, 37, 300, 4, 2, 64, False, None, None, 64, 128),       # Sq < Sk
]
# the bf16 route only: every autotuner candidate at zamba2's heads, Sq
# that is no multiple of 16 (block_q rounds up to 160 and 224 rows),
# GQA 4:1 at head_dim 128, window + softcap at 80
BF16_FLASH_CASES = [
    (1, 640, 640, 32, 32, 80, True, None, None, bq, bk)
    for bq in (64, 128, 256) for bk in (64, 128, 256)] + [
    (1, 130, 130, 4, 2, 80, True, None, None, 256, 256),
    (1, 200, 200, 4, 4, 64, False, None, None, 256, 128),
    (2, 384, 384, 16, 4, 128, True, None, None, 128, 64),
    (1, 512, 512, 8, 2, 80, True, 100, 20.0, 128, 128),
    # zamba2-7b's shared attention: head_dim 224, a ragged prompt
    (1, 1021, 1021, 32, 32, 224, True, None, None, 128, 64),
    (1, 300, 300, 8, 8, 224, True, None, None, 64, 64),
]


@pytest.mark.parametrize(
    "dtype,B,Sq,Sk,H,Hk,hd,causal,window,softcap,bq,bk",
    [(dt, *c) for c in FLASH_CASES for dt in (torch.float32, torch.bfloat16)]
    + [(torch.bfloat16, *c) for c in BF16_FLASH_CASES])
def test_flash_attention_kernel_matches_plain(cuda, B, Sq, Sk, H, Hk, hd,
                                              causal, window, softcap, bq,
                                              bk, dtype):
    """bf16 at 3e-2: besides the inputs' rounding, the kernel rounds P to
    bf16 before the PV product (at most 2**-8 relative per term)."""
    rng = np.random.default_rng(0)
    q = _randn(rng, (B, Sq, H, hd), dtype, cuda)
    k = _randn(rng, (B, Sk, Hk, hd), dtype, cuda)
    v = _randn(rng, (B, Sk, Hk, hd), dtype, cuda)
    before = _counted("flash_attention_launches")
    got = fa_mod.flash_attention(q, k, v, causal=causal, window=window,
                                 softcap=softcap, block_q=bq, block_k=bk)
    torch.cuda.synchronize()
    assert _counted("flash_attention_launches") == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    want = flash_attention_ref(q.float(), k.float(), v.float(),
                               causal=causal, window=window, softcap=softcap)
    _close(got, want, TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_fully_masked_rows_are_zero(cuda, dtype):
    """Rows whose window lies wholly past Sk have no unmasked key."""
    rng = np.random.default_rng(1)
    q = _randn(rng, (1, 384, 2, 64), dtype, cuda)
    k = _randn(rng, (1, 200, 2, 64), dtype, cuda)
    got = fa_mod.flash_attention(q, k, k, causal=True, window=64)
    want = flash_attention_ref(q.float(), k.float(), k.float(), causal=True,
                               window=64)
    assert torch.isfinite(got).all()
    assert (got[:, 263:] == 0).all()
    _close(got, want, TOL[dtype])


@pytest.mark.parametrize("hd,dtype", [(256, torch.bfloat16),
                                      (80, torch.float32)])
def test_flash_attention_refuses_oversized_tiles(cuda, hd, dtype):
    x = torch.zeros((1, 512, 2, hd), device=cuda, dtype=dtype)
    before = _counted("flash_attention_launches")
    with pytest.raises(ValueError, match="shared memory"):
        fa_mod.flash_attention(x, x, x, block_q=256, block_k=256)
    assert _counted("flash_attention_launches") == before


def test_flash_attention_bf16_refuses_other_head_dims(cuda):
    """The tensor-core route takes head_dim % 16 == 0 up to 256; it never
    hands another shape to the plain version or the fp32 kernel."""
    before = _counted("flash_attention_launches")
    for hd in (72, 272):
        x = torch.zeros((1, 64, 2, hd), device=cuda, dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="head_dim"):
            fa_mod.flash_attention(x, x, x)
    x = torch.zeros((1, 640, 2, 64), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="block_q"):
        fa_mod.flash_attention(x, x, x, block_q=512)
    assert _counted("flash_attention_launches") == before
    y = torch.zeros((1, 64, 2, 72), device=cuda)      # fp32 takes any width
    assert (fa_mod.flash_attention(y, y, y) == 0).all()


def test_flash_attention_bf16_kernel_uses_tensor_cores(cuda):
    """Every bf16 instance holds HMMA instructions; the fp32 SIMT kernel
    holds none."""
    counts = {f: c["HMMA"] for f, c in
              _build.sass_opcodes("flash_attention").items()}
    mma = fa_mod.mma_instances(counts)
    simt = [n for f, n in counts.items() if "fa_kernel" in f]
    assert sorted(mma) == list(fa_mod.MMA_HEAD_DIMS), counts
    assert all(n > 0 for ns in mma.values() for n in ns), counts
    assert simt and not any(simt), counts


def test_flash_attention_bf16_kernels_do_not_spill(cuda):
    """ptxas reports no spill stores for any bf16 instance at head_dim <=
    128, whichever block_q launches it."""
    _build.build_all()
    report = fa_mod.mma_instances(_build.ptxas_report("flash_attention"))
    small = {hd: entries for hd, entries in report.items() if hd <= 128}
    assert sorted(small) == list(range(16, 129, 16)), report
    for hd, entries in small.items():
        assert all(e["spill_stores"] == 0 for e in entries), (hd, entries)


def test_flash_attention_raises_on_unsupported_dtype(cuda):
    x = torch.zeros((1, 64, 2, 32), device=cuda, dtype=torch.float16)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fa_mod.flash_attention(x, x, x)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,P,N,chunk", [
    (1, 256, 2, 64, 64, 64),
    (2, 256, 4, 64, 32, 128),
    (1, 512, 1, 128, 64, 128),
    (1, 200, 2, 32, 16, 128),                   # uneven
    (1, 257, 2, 32, 16, 128),
    (1, 1024, 4, 80, 64, 32),                   # zamba2 widths
    (1, 100, 2, 64, 32, 128),                   # S < chunk
    (1, 1, 2, 32, 16, 64),                      # S = 1
    (2, 300, 3, 40, 24, 64),                    # P, N not multiples of 16
    (2, 513, 2, 128, 64, 64),                   # P 128, B 2, ragged
])
@pytest.mark.parametrize("la_dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_kernel_matches_plain(cuda, B, S, H, P, N, chunk, dtype,
                                       la_dtype):
    rng = np.random.default_rng(2)
    x = _randn(rng, (B, S, H, P), dtype, cuda)
    log_a = -torch.nn.functional.softplus(
        _randn(rng, (B, S, H), torch.float32, cuda)).to(la_dtype)
    b = _randn(rng, (B, S, H, N), dtype, cuda)
    c = _randn(rng, (B, S, H, N), dtype, cuda)
    before = _counted("ssd_scan_launches")
    y, fin = ssd_mod.ssd_scan(x, log_a, b, c, chunk=chunk)
    torch.cuda.synchronize()
    assert _counted("ssd_scan_launches") == before + 1
    assert y.dtype == dtype and fin.dtype == torch.float32
    y_ref, fin_ref = ssd_ref(x.float(), log_a.float(), b.float(), c.float(),
                             chunk=chunk)
    _close(y, y_ref, SSD_TOL[dtype])
    _close(fin, fin_ref, SSD_TOL[torch.float32])


@pytest.mark.parametrize("B,S,H,P,N,chunk", [
    (1, 512, 4, 384, 384, 128),                 # the mLSTM's widths
    (2, 300, 2, 200, 136, 64),                  # ragged tiles of P and N
    (1, 257, 2, 48, 96, 128),                   # wide by N alone
    (1, 100, 2, 160, 32, 32),                   # wide by P alone
    (1, 8192, 4, 384, 384, 128),                # 64 chunks
    (8, 512, 4, 384, 384, 128),                 # the train path's shape
    (2, 4096, 4, 384, 384, 128),                # 256 (batch, head, chunk)
    (1, 2000, 4, 384, 384, 128),                # a ragged last chunk
    (2, 300, 2, 196, 72, 64),                   # P not a multiple of 8
    (1, 1, 2, 200, 136, 128),                   # S = 1
])
@pytest.mark.parametrize("la_dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_bf16_wide_route_matches_plain(cuda, B, S, H, P, N, chunk,
                                                la_dtype):
    """P > 128 or N > 64: ssd_wide_state walks the chunks per 64 x 128
    state tile, ssd_wide_scan streams N in slabs of 64 over P tiles of
    128; more (batch, head, chunk) work than the card has SMs, many
    chunks, a last chunk cut short and rows TMA cannot read as they are
    (P = 196) included."""
    rng = np.random.default_rng(12)
    x = _randn(rng, (B, S, H, P), torch.bfloat16, cuda)
    log_a = -torch.nn.functional.softplus(
        _randn(rng, (B, S, H), torch.float32, cuda)).to(la_dtype)
    b = (_randn(rng, (B, S, H, N), torch.float32, cuda) / N ** 0.5).to(
        torch.bfloat16)
    c = _randn(rng, (B, S, H, N), torch.bfloat16, cuda)
    before = _counted("ssd_scan_launches")
    y, fin = ssd_mod.ssd_scan(x, log_a, b, c, chunk=chunk)
    torch.cuda.synchronize()
    assert _counted("ssd_scan_launches") == before + 1
    y_ref, fin_ref = ssd_ref(x.float(), log_a.float(), b.float(), c.float(),
                             chunk=chunk)
    _close(y, y_ref, SSD_TOL[torch.bfloat16])
    _close(fin, fin_ref, SSD_TOL[torch.float32])


def test_ssd_scan_bf16_wide_route_takes_strided_and_broadcast_b_c(cuda):
    """The wide route reads b and c through TMA maps of their own strides:
    b a strided view (the first 384 of 768 columns), c shared by the heads
    and then by the batch (stride-0 views), each against the plain
    version."""
    rng = np.random.default_rng(14)
    B, S, H, P = 2, 640, 4, 384
    x = _randn(rng, (B, S, H, P), torch.bfloat16, cuda)
    la = -torch.nn.functional.softplus(
        _randn(rng, (B, S, H), torch.float32, cuda))
    wide_b = (_randn(rng, (B, S, H, 2 * P), torch.float32, cuda) / P ** 0.5
              ).to(torch.bfloat16)
    b = wide_b[..., :P]
    c_head = _randn(rng, (B, S, 1, P), torch.bfloat16, cuda).expand(
        B, S, H, P)
    c_batch = _randn(rng, (1, S, H, P), torch.bfloat16, cuda).expand(
        B, S, H, P)
    for c in (c_head, c_batch):
        assert 0 in c.stride()
        before = _counted("ssd_scan_wide_launches")
        y, fin = ssd_mod.ssd_scan(x, la, b, c, chunk=128)
        torch.cuda.synchronize()
        assert _counted("ssd_scan_wide_launches") == before + 1
        y_ref, fin_ref = ssd_ref(x.float(), la, b.float(), c.float(),
                                 chunk=128)
        _close(y, y_ref, SSD_TOL[torch.bfloat16])
        _close(fin, fin_ref, SSD_TOL[torch.float32])


def test_ssd_scan_bf16_wide_route_is_bitwise_repeatable(cuda):
    """Two calls on the same inputs give the same bits: no atomics, the
    states handed on in a fixed order."""
    rng = np.random.default_rng(15)
    x = _randn(rng, (1, 2048, 4, 384), torch.bfloat16, cuda)
    b = (_randn(rng, (1, 2048, 4, 384), torch.float32, cuda) / 384 ** 0.5
         ).to(torch.bfloat16)
    c = _randn(rng, (1, 2048, 4, 384), torch.bfloat16, cuda)
    la = torch.nn.functional.logsigmoid(
        _randn(rng, (1, 2048, 4), torch.float32, cuda))
    y1, fin1 = ssd_mod.ssd_scan(x, la, b, c, chunk=128)
    y2, fin2 = ssd_mod.ssd_scan(x, la, b, c, chunk=128)
    assert torch.equal(y1, y2) and torch.equal(fin1, fin2)


@pytest.mark.parametrize("B,S,H,P,N", [
    (1, 2048, 4, 384, 384),                     # the mLSTM's widths
    (2, 300, 2, 200, 136),                      # ragged tiles of P and N
])
@pytest.mark.parametrize("la_dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_bf16_wide_route_holds_unit_scale_b(cuda, B, S, H, P, N,
                                                     la_dtype):
    """b at unit scale, not the mLSTM's k / sqrt(N): the scores and the
    inter-chunk term are sqrt(N) times larger, and the states handed from
    ssd_wide_state to ssd_wide_scan keep a high and a low bf16 part, so y
    holds the bf16 tolerance and the final state the fp32 one."""
    rng = np.random.default_rng(16)
    x = _randn(rng, (B, S, H, P), torch.bfloat16, cuda)
    log_a = -torch.nn.functional.softplus(
        _randn(rng, (B, S, H), torch.float32, cuda)).to(la_dtype)
    b = _randn(rng, (B, S, H, N), torch.bfloat16, cuda)
    c = _randn(rng, (B, S, H, N), torch.bfloat16, cuda)
    before = _counted("ssd_scan_wide_launches")
    y, fin = ssd_mod.ssd_scan(x, log_a, b, c, chunk=128)
    torch.cuda.synchronize()
    assert _counted("ssd_scan_wide_launches") == before + 1
    y_ref, fin_ref = ssd_ref(x.float(), log_a.float(), b.float(), c.float(),
                             chunk=128)
    _close(y, y_ref, SSD_TOL[torch.bfloat16])
    _close(fin, fin_ref, SSD_TOL[torch.float32])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,P,N,G,chunk", [
    (1, 1021, 112, 64, 64, 2, 256),             # zamba2-7b, a ragged prompt
    (1, 3468, 112, 64, 64, 2, 256),             # its longest prompt
    (2, 300, 8, 32, 16, 4, 64),                 # 4 groups of 2, B 2
    (1, 13, 4, 16, 16, 2, 8),                   # the CPU tests' widths
])
def test_ssd_scan_grouped_b_c_match_the_per_head_maps(cuda, B, S, H, P, N,
                                                      G, chunk, dtype):
    """b, c of G groups (H / G heads each) cut from one projection, as the
    Mamba-2 block hands them over: the kernel reads them by group, and
    equals its own launch on maps copied to each head bit for bit (the
    same inputs, the same arithmetic) and the plain version within
    ``SSD_TOL``.  fp32 at most at chunk 64, what its shared memory holds."""
    chunk = chunk if dtype == torch.bfloat16 else min(chunk, 64)
    rng = np.random.default_rng(9)
    x = _randn(rng, (B, S, H, P), dtype, cuda)
    log_a = -torch.nn.functional.softplus(
        _randn(rng, (B, S, H), torch.float32, cuda))
    xbc = _randn(rng, (B, S, 2 * G * N + 8), dtype, cuda)
    b = xbc[..., :G * N].unflatten(2, (G, N))
    c = xbc[..., G * N:2 * G * N].unflatten(2, (G, N))
    before = _counted("ssd_scan_launches")
    y, fin = ssd_mod.ssd_scan(x, log_a, b, c, chunk=chunk)
    per_head = [t.repeat_interleave(H // G, dim=2) for t in (b, c)]
    y_h, fin_h = ssd_mod.ssd_scan(x, log_a, *per_head, chunk=chunk)
    torch.cuda.synchronize()
    assert _counted("ssd_scan_launches") == before + 2
    assert torch.equal(y, y_h) and torch.equal(fin, fin_h)
    y_ref, fin_ref = ssd_ref(x.float(), log_a, b.float(), c.float(),
                             chunk=chunk)
    _close(y, y_ref, SSD_TOL[dtype])
    _close(fin, fin_ref, SSD_TOL[torch.float32])


def test_ssd_scan_takes_strided_b_c(cuda):
    """The node passes b = c = x[..., :N], a strided view of x."""
    rng = np.random.default_rng(3)
    x = torch.tanh(_randn(rng, (1, 384, 4, 80), torch.bfloat16, cuda))
    la = -torch.nn.functional.softplus(x.mean(dim=-1))
    bc = x[..., :64]
    y, fin = ssd_mod.ssd_scan(x, la, bc, bc, chunk=128)
    y_ref, fin_ref = ssd_ref(x.float(), la.float(), bc.float(), bc.float(),
                             chunk=128)
    _close(y, y_ref, SSD_TOL[torch.bfloat16])
    _close(fin, fin_ref, SSD_TOL[torch.bfloat16])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_no_nan_from_large_decay(cuda, dtype):
    """log_a = -20 at every step: exp(seg_i - seg_j) above the diagonal
    and exp(-seg) would overflow; the kernels never form them."""
    rng = np.random.default_rng(7)
    x = _randn(rng, (1, 128, 2, 16), dtype, cuda)
    b = _randn(rng, (1, 128, 2, 8), dtype, cuda)
    c = _randn(rng, (1, 128, 2, 8), dtype, cuda)
    la = torch.full((1, 128, 2), -20.0, device=cuda)
    y, fin = ssd_mod.ssd_scan(x, la, b, c, chunk=128)
    assert torch.isfinite(y).all() and torch.isfinite(fin).all()
    y_ref, fin_ref = ssd_ref(x.float(), la, b.float(), c.float(), chunk=128)
    _close(y, y_ref, SSD_TOL[dtype])
    _close(fin, fin_ref, SSD_TOL[torch.float32])


@pytest.mark.parametrize("chunk", [32, 64, 128, 256])
def test_ssd_scan_bf16_every_chunk_at_zamba2_widths(cuda, chunk):
    """The node's inputs (b = c strided views of x, bf16 log_a) at every
    autotuner candidate, against the plain version and its final state."""
    rng = np.random.default_rng(8)
    x = torch.tanh(_randn(rng, (1, 1000, 4, 80), torch.bfloat16, cuda))
    la = -torch.nn.functional.softplus(x.mean(dim=-1))
    bc = x[..., :64]
    before = _counted("ssd_scan_launches")
    y, fin = ssd_mod.ssd_scan(x, la, bc, bc, chunk=chunk)
    torch.cuda.synchronize()
    assert _counted("ssd_scan_launches") == before + 1
    y_ref, fin_ref = ssd_ref(x.float(), la.float(), bc.float(), bc.float(),
                             chunk=chunk)
    _close(y, y_ref, SSD_TOL[torch.bfloat16])
    _close(fin, fin_ref, SSD_TOL[torch.float32])


def test_ssd_scan_bf16_refuses_what_it_does_not_take(cuda):
    """The bf16 passes take chunk <= 256 with P <= 128 and N <= 64, or
    chunk <= 128 with P and N up to 384; they never hand another shape to
    the plain version or the fp32 kernel."""
    before = _counted("ssd_scan_launches")
    for P, N, chunk in ((392, 16, 64), (64, 392, 64), (64, 16, 512),
                        (136, 16, 256), (384, 384, 256)):
        x = torch.zeros((1, 1024, 1, P), device=cuda, dtype=torch.bfloat16)
        b = torch.zeros((1, 1024, 1, N), device=cuda, dtype=torch.bfloat16)
        la = torch.zeros((1, 1024, 1), device=cuda)
        with pytest.raises(ValueError, match="bf16 kernel"):
            ssd_mod.ssd_scan(x, la, b, b, chunk=chunk)
    assert _counted("ssd_scan_launches") == before


def test_ssd_scan_bf16_kernels_use_tensor_cores_without_spills(cuda):
    """The narrow route's mma.sync passes hold HMMA in every instance, the
    wide route's wgmma passes HGMMA and TMA loads (UTMALDG), and none
    spills; the fp32 SIMT kernel holds neither product."""
    _build.build_all()
    ptxas = ssd_mod.mma_passes(_build.ptxas_report("ssd_scan"))
    sass = _build.sass_opcodes("ssd_scan")
    ops = ssd_mod.mma_passes(sass)
    assert sorted(ops) == ["ssd_chunk_scan", "ssd_chunk_state",
                           "ssd_wide_scan", "ssd_wide_state"], sorted(sass)
    for name, instances in ops.items():
        assert all(o[ssd_mod.mma_opcode(name)] > 0 for o in instances), \
            (name, instances)
        if name in ssd_mod.WIDE_PASSES:
            assert all(o["UTMALDG"] > 0 for o in instances), \
                (name, instances)
    assert all(e["spill_stores"] == 0 for es in ptxas.values() for e in es), \
        ptxas
    simt = [o for f, o in sass.items() if "ssd_kernel" in f]
    assert simt and not any(o["HMMA"] or o["HGMMA"] for o in simt), simt


def test_ssd_scan_mlstm_widths_bf16_and_fp32_refusal(cuda):
    """xlstm-125m's mLSTM: x = v i, b = k, c = q at 4 heads of 384, log_a
    = log sigmoid(f) in fp32, chunk 128; the bf16 wide route against the
    plain version, and the fp32 route, which cannot hold these widths,
    refusing them without a launch."""
    rng = np.random.default_rng(11)
    shape = (2, 1024, 4, 384)
    v, k, q = (_randn(rng, shape, torch.bfloat16, cuda) for _ in range(3))
    k = (k.float() / 384 ** 0.5).to(torch.bfloat16)
    f, i = (_randn(rng, shape[:3], torch.float32, cuda) for _ in range(2))
    x = v * torch.sigmoid(i)[..., None].to(torch.bfloat16)
    la = torch.nn.functional.logsigmoid(f)
    before, wide_before = _counts("ssd_scan_launches",
                                  "ssd_scan_wide_launches")
    y, fin = ssd_mod.ssd_scan(x, la, k, q, chunk=128)
    torch.cuda.synchronize()
    assert _counted("ssd_scan_launches") == before + 1
    assert _counted("ssd_scan_wide_launches") == wide_before + 1
    y_ref, fin_ref = ssd_ref(x.float(), la, k.float(), q.float(), chunk=128)
    _close(y, y_ref, SSD_TOL[torch.bfloat16])
    _close(fin, fin_ref, SSD_TOL[torch.float32])
    with pytest.raises(ValueError, match="fp32 kernel.*shared memory"):
        ssd_mod.ssd_scan(x.float(), la, k.float(), q.float(), chunk=128)
    assert _counted("ssd_scan_launches") == before + 1


def test_ssd_scan_refuses_oversized_chunk(cuda):
    x = torch.zeros((1, 512, 2, 80), device=cuda)
    b = torch.zeros((1, 512, 2, 64), device=cuda)
    la = torch.zeros((1, 512, 2), device=cuda)
    before = _counted("ssd_scan_launches")
    with pytest.raises(ValueError, match="shared memory"):
        ssd_mod.ssd_scan(x, la, b, b, chunk=256)
    assert _counted("ssd_scan_launches") == before


# the one-token SSD decode at each path's widths, B, H, G, N, P:
# zamba2-7b's tick (34 rows, 112 heads in 2 groups of b and c), zamba2-2.7b's
# (80 heads, one map as a stride-0 view), xlstm-125m's mLSTM (4 heads of
# 384, a map a head: G = H)
SSD_DECODE_SHAPES = {"zamba2-7b": (34, 112, 2, 64, 64),
                     "zamba2-2.7b": (4, 80, 1, 64, 64),
                     "xlstm-125m": (4, 4, 4, 384, 384)}
# the new state takes the plain version's roundings (two products and their
# sum, no FMA contraction), so only expf's last bits could part them; y
# sums N in another order (and with FMAs) and is rounded to bf16 once: TOL
SSD_DECODE_STATE_TOL = dict(rtol=1e-6, atol=1e-6)


def _ssd_decode_case(arch, device):
    B, H, G, N, P = SSD_DECODE_SHAPES[arch]
    rng = np.random.default_rng(31)
    state = _randn(rng, (B, H, N, P), torch.float32, device)
    x = _randn(rng, (B, 1, H, P), torch.bfloat16, device)
    log_a = -torch.from_numpy(rng.uniform(0.0, 2.0, (B, 1, H))
                              .astype(np.float32)).to(device)
    if G == 1:
        b, c = (_randn(rng, (B, 1, 1, N), torch.bfloat16, device)
                .expand(B, 1, H, N) for _ in range(2))
    else:   # cut from one projection, as the blocks hand them over
        bc = _randn(rng, (B, 1, 2 * G * N + 8), torch.bfloat16, device)
        b, c = (bc[..., i * G * N:(i + 1) * G * N].unflatten(2, (G, N))
                for i in range(2))
    return state, x, log_a, b, c


@pytest.mark.parametrize("arch,out", [
    *((a, o) for a in sorted(SSD_DECODE_SHAPES)
      for o in ("alias", "distinct", "none")),
    ("zamba2-7b", "graph")])
def test_ssd_decode_kernel_matches_plain(cuda, arch, out):
    """The decode kernel against its plain version, fp32 state and bf16 x:
    writing the state in place (``out`` is the state), into another
    buffer, or into a new tensor (the state left as it was); and captured
    in a CUDA graph in place, as the graphed decode step runs it, two
    replays equal to two eager calls bit for bit.  Each call counts a
    launch (a capture too, a replay not) in the ``ssd_decode_launches``
    counter."""
    from repro_torch._device import capture
    state, x, log_a, b, c = _ssd_decode_case(arch, cuda)
    want_y, want_st = ssd_decode_ref(state, x, log_a, b, c)
    before = state.clone()
    launched = _counted("ssd_decode_launches")
    if out == "graph":
        eager = state.clone()
        eager_y = [ssd_mod.ssd_decode(eager, x, log_a, b, c, out=eager)[0]
                   for _ in range(2)]
        graph, (y, st) = capture(
            lambda s: ssd_mod.ssd_decode(s, x, log_a, b, c, out=s), (state,),
            cuda)
        assert st is state and torch.equal(state, before)
        for k in range(2):
            graph.replay()
            torch.cuda.synchronize()
            assert torch.equal(y, eager_y[k]), k
            if k == 0:
                _close(y, want_y, TOL[torch.bfloat16])
                torch.testing.assert_close(state, want_st,
                                           **SSD_DECODE_STATE_TOL)
        assert torch.equal(state, eager)
        graph.reset()
        calls = 3
    else:
        dst = {"alias": state, "none": None,
               "distinct": torch.full_like(state, float("nan"))}[out]
        y, st = ssd_mod.ssd_decode(state, x, log_a, b, c, out=dst)
        torch.cuda.synchronize()
        assert st is dst if dst is not None else st is not state
        if out != "alias":
            assert torch.equal(state, before)
        _close(y, want_y, TOL[torch.bfloat16])
        torch.testing.assert_close(st, want_st, **SSD_DECODE_STATE_TOL)
        calls = 1
    assert y.dtype == torch.bfloat16 and y.shape == x.shape
    assert _counted("ssd_decode_launches") - launched == calls


def test_ssd_decode_refuses_what_it_does_not_take(cuda):
    """P of no multiple of 4, an ``out`` the kernel cannot write as it is,
    a bf16 state: each raises, and nothing launches."""
    state, x, log_a, b, c = _ssd_decode_case("zamba2-2.7b", cuda)
    launched = _counted("ssd_decode_launches")
    with pytest.raises(ValueError, match="multiple of 4"):
        ssd_mod.ssd_decode(state[..., :62], x[..., :62], log_a, b, c)
    with pytest.raises(ValueError, match="contiguous"):
        ssd_mod.ssd_decode(state, x, log_a, b, c,
                           out=torch.empty_like(state).transpose(2, 3))
    with pytest.raises(ValueError, match="float32 state"):
        ssd_mod.ssd_decode(state.bfloat16(), x, log_a, b, c)
    assert _counted("ssd_decode_launches") == launched


def _decode_inputs(seed, B, Smax, H, Hk, hd, dtype, device, lengths=None):
    rng = np.random.default_rng(seed)
    q = _randn(rng, (B, H, hd), dtype, device)
    k = _randn(rng, (B, Smax, Hk, hd), dtype, device)
    v = _randn(rng, (B, Smax, Hk, hd), dtype, device)
    if lengths is None:           # 0, 1 and Smax first, the rest at random
        lengths = [0, 1, Smax][:B] + \
            rng.integers(0, Smax + 1, size=max(0, B - 3)).tolist()
    return q, k, v, torch.tensor(lengths, dtype=torch.int32, device=device)


def _fitting_block_ks(q, k, device):
    limit = card_smem_limit(device)
    return [bk for bk in (32, 128, 256, 512)
            if da_mod.smem_bytes({"block_k": bk}, (q.shape, k.shape),
                                 q.dtype) <= limit]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Smax,H,Hk,hd,softcap", [
    (2, 512, 4, 4, 64, None),                   # MHA
    (4, 1024, 8, 2, 64, None),                  # GQA 4:1
    (3, 512, 8, 1, 128, None),                  # MQA, a group of 8
    (3, 300, 4, 2, 64, None),                   # uneven cache
    (3, 200, 2, 2, 64, None),                   # Smax < block_k
    (4, 1024, 8, 2, 64, 30.0),                  # softcap
    (3, 256, 12, 1, 64, None),                  # a group cut into 8 + 4
    (3, 256, 6, 2, 32, None),                   # a group of 3, padded to 4
    (3, 1024, 4, 2, 256, None),                 # head_dim 256
    (6, 4096, 32, 8, 128, None),                # granite-8b heads
    (72, 256, 8, 8, 64, None),                  # a grid large enough unsplit
    (2, 512, 16, 1, 128, None),                 # a group of 16, one tile
    (2, 512, 32, 1, 64, None),                  # 32: two pieces of 16
    (3, 700, 24, 2, 128, 20.0),                 # 12 a group, softcap
    (2, 1024, 16, 4, 256, 50.0),                # head_dim 256, softcap
    (4, 1024, 32, 32, 80, None),                # zamba2-2.7b: head_dim 80
    (2, 300, 8, 2, 80, 30.0),                   # head_dim 80, uneven, cap
    (4, 1024, 32, 32, 224, None),               # zamba2-7b: head_dim 224
    (3, 700, 8, 8, 224, None),                  # head_dim 224, uneven
])
def test_decode_attention_kernel_matches_plain(cuda, B, Smax, H, Hk, hd,
                                               softcap, dtype):
    q, k, v, lengths = _decode_inputs(4, B, Smax, H, Hk, hd, dtype, cuda)
    want = decode_attention_ref(q.float(), k.float(), v.float(), lengths,
                                softcap=softcap)
    block_ks = _fitting_block_ks(q, k, cuda)
    assert block_ks
    for bk in block_ks:
        before = _counted("decode_attention_launches")
        got = da_mod.decode_attention(q, k, v, lengths, softcap=softcap,
                                      block_k=bk)
        torch.cuda.synchronize()
        assert _counted("decode_attention_launches") == before + 1
        assert got.dtype == dtype and got.shape == q.shape
        _close(got, want, TOL[dtype])
        assert (got[lengths == 0] == 0).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_whisper_cross_cache(cuda, dtype):
    """whisper-medium's cross-attention in decode: every row reads the
    whole 1500-entry cross cache (16 heads of 64, width 8)."""
    q, k, v, _ = _decode_inputs(15, 8, 1500, 16, 16, 64, dtype, cuda)
    lengths = torch.full((8,), 1500, dtype=torch.int32, device=cuda)
    before = _counted("decode_attention_launches")
    got = da_mod.decode_attention(q, k, v, lengths)
    torch.cuda.synchronize()
    assert _counted("decode_attention_launches") == before + 1
    _close(got, decode_attention_ref(q.float(), k.float(), v.float(),
                                     lengths), TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_random_lengths(cuda, dtype):
    """Lengths drawn over the whole of [0, Smax], with 0, 1 and Smax."""
    q, k, v, lengths = _decode_inputs(5, 16, 777, 8, 2, 128, dtype, cuda)
    assert {0, 1, 777} <= set(lengths.tolist())
    got = da_mod.decode_attention(q, k, v, lengths, block_k=128)
    want = decode_attention_ref(q.float(), k.float(), v.float(), lengths)
    _close(got, want, TOL[dtype])


def test_decode_attention_masking_exact(cuda):
    """Entries past a row's length are never read."""
    q, k, v, lengths = _decode_inputs(6, 3, 1000, 8, 2, 64, torch.float32,
                                      cuda, lengths=[300, 0, 999])
    got = da_mod.decode_attention(q, k, v, lengths, block_k=128)
    k2, v2 = k.clone(), v.clone()
    for row, n in enumerate(lengths.tolist()):
        k2[row, n:] = 1e6
        v2[row, n:] = float("nan")
    got2 = da_mod.decode_attention(q, k2, v2, lengths, block_k=128)
    assert torch.equal(got, got2)
    assert (got[1] == 0).all() and torch.isfinite(got).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Smax,H,Hk,hd,softcap,window", [
    (6, 1024, 16, 8, 256, 50.0, 100),           # gemma2-9b widths, softcap
    (6, 700, 8, 2, 64, None, 64),               # a window of one tile
    (6, 4096, 32, 8, 128, None, 1000),          # granite-8b heads, long
    (6, 333, 32, 32, 80, None, 17),             # head_dim 80, ragged tiles
    (6, 256, 4, 2, 64, None, 4096),             # a window past the cache
])
def test_decode_attention_window_matches_plain(cuda, B, Smax, H, Hk, hd,
                                               softcap, window, dtype):
    """A sliding window masks kpos < length - window: lengths 0, 1, inside
    and past the window, and the whole cache; rows before the window are
    never read (NaN there changes nothing)."""
    lengths = [0, 1, min(window, Smax) // 2, min(window + 1, Smax),
               Smax - 5, Smax]
    q, k, v, lengths = _decode_inputs(11, B, Smax, H, Hk, hd, dtype, cuda,
                                      lengths=lengths)
    want = decode_attention_ref(q.float(), k.float(), v.float(), lengths,
                                softcap=softcap, window=window)
    k2, v2 = k.clone(), v.clone()
    for row, n in enumerate(lengths.tolist()):
        k2[row, :max(n - window, 0)] = float("nan")
        v2[row, :max(n - window, 0)] = float("nan")
    for bk in _fitting_block_ks(q, k, cuda):
        before = _counted("decode_attention_launches")
        got = da_mod.decode_attention(q, k, v, lengths, softcap=softcap,
                                      window=window, block_k=bk)
        assert _counted("decode_attention_launches") == before + 1
        _close(got, want, TOL[dtype])
        assert (got[lengths == 0] == 0).all()
        got2 = da_mod.decode_attention(q, k2, v2, lengths, softcap=softcap,
                                       window=window, block_k=bk)
        assert torch.equal(got, got2)


def test_decode_attention_window_splits_cover_only_the_window(cuda):
    """With a window the cache is split over the tiles a window touches,
    not over the whole cache."""
    q = torch.zeros((2, 16, 256), device=cuda, dtype=torch.bfloat16)
    k = torch.zeros((2, 4096, 8, 256), device=cuda, dtype=torch.bfloat16)
    full = da_mod.split_plan(q, k, 128)
    windowed = da_mod.split_plan(q, k, 128, window=100)
    assert windowed["nsplit"] * windowed["tiles_per_split"] >= 3
    assert windowed["nsplit"] * windowed["tiles_per_split"] < \
        full["nsplit"] * full["tiles_per_split"]


def test_decode_attention_refuses_oversized_tiles(cuda):
    q = torch.zeros((2, 32, 128), device=cuda, dtype=torch.bfloat16)
    k = torch.zeros((2, 4096, 8, 128), device=cuda, dtype=torch.bfloat16)
    lengths = torch.full((2,), 4096, dtype=torch.int32, device=cuda)
    before = _counted("decode_attention_launches")
    with pytest.raises(ValueError, match="shared memory"):
        da_mod.decode_attention(q, k, k, lengths, block_k=512)
    with pytest.raises(ValueError, match="one dtype"):
        da_mod.decode_attention(q, k.float(), k, lengths)
    assert _counted("decode_attention_launches") == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_split_past_length(cuda, dtype):
    """Two rows over a long cache: the cache is split, and the short row's
    later splits lie wholly past its length (m = -inf, l = 0)."""
    q, k, v, lengths = _decode_inputs(9, 2, 4096, 8, 2, 128, dtype, cuda,
                                      lengths=[100, 4096])
    for bk in _fitting_block_ks(q, k, cuda):
        plan = da_mod.split_plan(q, k, bk)
        rows = plan["tiles_per_split"] * (64 if dtype == torch.bfloat16
                                          else plan["block_k"])
        assert plan["nsplit"] > 1 and rows < 4096 - 100
        got = da_mod.decode_attention(q, k, v, lengths, block_k=bk)
        want = decode_attention_ref(q.float(), k.float(), v.float(), lengths)
        _close(got, want, TOL[dtype])


def test_decode_attention_split_fills_one_wave(cuda):
    """At granite-8b widths the grid is at most one wave of resident CTAs,
    from the occupancy the card reports."""
    q = torch.zeros((16, 32, 128), device=cuda, dtype=torch.bfloat16)
    k = torch.zeros((16, 4096, 8, 128), device=cuda, dtype=torch.bfloat16)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for bk in _fitting_block_ks(q, k, cuda):
        plan = da_mod.split_plan(q, k, bk)
        assert plan["ctas_per_sm"] >= 1
        assert 16 * 8 * plan["nsplit"] <= max(16 * 8,
                                              plan["ctas_per_sm"] * sms)


# a cache split on its sequence: the kernel's log-sum-exp and key bounds
# (starts) on each route, at the head_dims of the paths (80 zamba2, 128
# granite, 256 gemma2): (dtype, B, Smax, H, Hk, hd, softcap, nsplit > 1)
LSE_CASES = [(torch.bfloat16, 72, 256, 8, 8, 128, None, False),
             (torch.bfloat16, 2, 4096, 32, 8, 128, None, True),
             (torch.bfloat16, 72, 256, 32, 32, 80, None, False),
             (torch.bfloat16, 2, 2048, 32, 32, 80, 30.0, True),
             (torch.bfloat16, 72, 256, 16, 8, 256, 50.0, False),
             (torch.bfloat16, 2, 4096, 16, 8, 256, 50.0, True),
             (torch.float32, 2, 1024, 32, 8, 128, None, True),
             (torch.float32, 3, 512, 16, 8, 256, 50.0, None),
             (torch.float32, 3, 512, 32, 32, 80, None, None)]


@pytest.mark.parametrize("dtype,B,Smax,H,Hk,hd,softcap,split", LSE_CASES)
def test_decode_attention_lse_and_starts_match_plain(cuda, dtype, B, Smax, H,
                                                     Hk, hd, softcap, split):
    """The kernel's lse ((B, H) fp32) and its starts against the plain
    version: rows with starts inside, at and past their length, a start
    that cuts a tile, with and without a window; the bf16 route unsplit
    (the mma kernel writes lse itself) and split (da_combine writes it),
    and the fp32 route (always through da_combine).  Keys before a start
    are never read (NaN there changes nothing)."""
    rng = np.random.default_rng(44)
    lengths = ([0, Smax, Smax // 2, 100, 65, 1] * B)[:B]
    q, k, v, lengths = _decode_inputs(44, B, Smax, H, Hk, hd, dtype, cuda,
                                      lengths=lengths)
    starts = torch.from_numpy(rng.integers(0, Smax + 1, B).astype(np.int32)
                              ).to(cuda)
    starts[:2] = torch.tensor([0, 37], dtype=torch.int32)[:B]
    starts[-1] = lengths[-1]                  # a row with no valid key
    if split is not None:
        assert (da_mod.split_plan(q, k)["nsplit"] > 1) == split
    for window in (None, 50):
        want, want_lse = decode_attention_ref(
            q.float(), k.float(), v.float(), lengths, softcap=softcap,
            window=window, starts=starts, return_lse=True)
        before = _counted("decode_attention_launches")
        got, lse = da_mod.decode_attention(q, k, v, lengths, softcap=softcap,
                                           window=window, starts=starts,
                                           return_lse=True)
        torch.cuda.synchronize()
        assert _counted("decode_attention_launches") == before + 1
        assert lse.dtype == torch.float32 and lse.shape == (B, H)
        _close(got, want, TOL[dtype])
        empty = torch.isneginf(want_lse)
        assert torch.equal(torch.isneginf(lse), empty)
        _close(lse[~empty], want_lse[~empty], TOL[torch.float32]
               if dtype == torch.float32 else dict(rtol=1e-3, atol=1e-3))
        assert (got[empty] == 0).all()
        k2, v2 = k.clone(), v.clone()
        for row, s0 in enumerate(starts.tolist()):
            k2[row, :s0] = float("nan")
            v2[row, :s0] = float("nan")
        got2, lse2 = da_mod.decode_attention(
            q, k2, v2, lengths, softcap=softcap, window=window, starts=starts,
            return_lse=True)
        assert torch.equal(got, got2) and torch.equal(lse, lse2)


# check_decode's bounds (chip_smoke.py): elementwise 0.1 x the output's
# RMS absolute + 1e-2 relative, the error's norm within 1e-2 of the output's
DEC_ATOL, DEC_RTOL, DEC_NORM = 0.1, 1e-2, 1e-2


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("R,window", [(2, None), (16, None), (4, 300),
                                      (16, 1000)])
def test_split_cache_recombined_equals_the_unsplit_kernel(cuda, dtype, R,
                                                          window):
    """The cache cut into R slices of its sequence, each slice through the
    kernel with its own lengths and starts (as each rank runs it), then
    ``combine_partials``: equal to the unsplit kernel and to the plain
    version within check_decode's bounds; a row wholly in one slice, and
    an empty row, included."""
    from repro_torch.kernels.ref import combine_partials
    from repro_torch.kernels.sharded import slice_bounds
    Smax = 4096
    lengths = [Smax, 3000, 2048, 700, 1, 0, 2049, 4000]
    q, k, v, lengths = _decode_inputs(45, 8, Smax, 32, 8, 128, dtype, cuda,
                                      lengths=lengths)
    Sl = Smax // R
    parts, lses = [], []
    before = _counted("decode_attention_launches")
    for r in range(R):
        off = r * Sl
        end, start = slice_bounds(lengths, off, Sl, window)
        o, lse = da_mod.decode_attention(
            q, k[:, off:off + Sl], v[:, off:off + Sl], end, starts=start,
            return_lse=True)
        parts.append(o)
        lses.append(lse)
    assert _counted("decode_attention_launches") == before + R
    got = combine_partials(torch.stack(parts), torch.stack(lses))
    whole = da_mod.decode_attention(q, k, v, lengths, window=window)
    want = decode_attention_ref(q.float(), k.float(), v.float(), lengths,
                                window=window)
    rms = want.float().pow(2).mean().sqrt().item()
    for ref_ in (whole, want):
        _close(got, ref_, dict(atol=DEC_ATOL * rms, rtol=DEC_RTOL))
        assert (torch.linalg.vector_norm(got.float() - ref_.float())
                <= DEC_NORM * torch.linalg.vector_norm(ref_.float()))
    assert (got[5] == 0).all() and torch.isfinite(got).all()


def test_decode_attention_bf16_refuses_other_head_dims(cuda):
    q = torch.zeros((2, 4, 96), device=cuda, dtype=torch.bfloat16)
    k = torch.zeros((2, 64, 2, 96), device=cuda, dtype=torch.bfloat16)
    lengths = torch.full((2,), 64, dtype=torch.int32, device=cuda)
    before = _counted("decode_attention_launches")
    with pytest.raises(ValueError, match="head_dim"):
        da_mod.decode_attention(q, k, k, lengths)
    assert _counted("decode_attention_launches") == before


def test_decode_attention_bf16_kernel_uses_tensor_cores_without_spills(cuda):
    """Every bf16 instance holds HMMA and spills nothing; the fp32 SIMT
    kernel holds no HMMA."""
    _build.build_all()
    ptxas = da_mod.mma_instances(_build.ptxas_report("decode_attention"))
    counts = {f: c["HMMA"]
              for f, c in _build.sass_opcodes("decode_attention").items()}
    hmma = da_mod.mma_instances(counts)
    assert sorted(hmma) == list(da_mod.MMA_HEAD_DIMS), counts
    assert all(n > 0 for n in hmma.values()), counts
    assert all(e["spill_stores"] == 0 for e in ptxas.values()), ptxas
    simt = [n for f, n in counts.items() if "da_partial" in f]
    assert simt and not any(simt), counts


# -- the CNN zoo's layer forms: the card against the CPU ----------------------
# fp32 with TF32 off on both; summation order and cuDNN's algorithms differ,
# so each output is held at a relative norm error of 1e-5.  A layout or
# padding fault gives errors of order 1.
ZOO_LAYER_TOL = 1e-5

ZOO_LAYERS = {  # input (H, W, C), the layer's constructor
    "conv3x3_same_s2_odd": ((17, 17, 5), lambda g: g.conv("l", 5, 8,
                                                         stride=2)),
    "conv7x7_same_s2_even": ((30, 30, 3), lambda g: g.conv("l", 3, 16, k=7,
                                                          stride=2)),
    "conv3x3_valid_s2": ((19, 19, 3), lambda g: g.conv(
        "l", 3, 8, stride=2, padding="VALID")),
    "dwconv_s1_relu6": ((13, 13, 24), lambda g: g.dw_conv("l", 24)),
    "dwconv_s2_even": ((14, 14, 24), lambda g: g.dw_conv("l", 24, stride=2)),
    "dwconv5_s1": ((11, 11, 16), lambda g: g.dw_conv("l", 16, k=5)),
    "maxpool_same_s2_even": ((16, 16, 8), lambda g: g.pool(
        "l", k=3, stride=2, padding="SAME")),
    "maxpool_same_s2_odd": ((15, 15, 8), lambda g: g.pool(
        "l", k=3, stride=2, padding="SAME")),
    "maxpool_valid_k3_s2": ((15, 15, 8), lambda g: g.pool("l", k=3,
                                                          stride=2)),
    "avgpool_same_s1": ((9, 9, 8), lambda g: g.pool(
        "l", k=3, stride=1, kind="avg", padding="SAME")),
    "avgpool_same_s2_even": ((10, 10, 8), lambda g: g.pool(
        "l", k=3, stride=2, kind="avg", padding="SAME")),
    "avgpool_valid_k2": ((14, 14, 8), lambda g: g.pool("l", kind="avg")),
    "gap": ((7, 7, 32), lambda g: g.gap("l")),
}


def _zoo_graph(device, shape, make, seed=0):
    g = cnn_zoo.ZooGraph("layer", torch.device(device), seed)
    prev = g.input(TensorSpec((1, *shape), torch.float32))
    g.add(make(g), [prev])
    g.trace()
    return g


def _rel(got, want):
    return (torch.linalg.vector_norm(got.cpu().double() - want.double())
            / torch.linalg.vector_norm(want.double())).item()


@pytest.mark.parametrize("form", sorted(ZOO_LAYERS))
def test_zoo_layer_matches_cpu(cuda, form):
    shape, make = ZOO_LAYERS[form]
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (1, *shape)).astype(np.float32))
    ref, card = _zoo_graph("cpu", shape, make), _zoo_graph(cuda, shape, make)
    want = ref.nodes[1].apply(x)
    got = card.nodes[1].apply(x.to(cuda))
    assert got.shape == want.shape == card.nodes[1].out_spec.shape
    assert got.is_contiguous()
    assert _rel(got, want) <= ZOO_LAYER_TOL


def test_zoo_flatten_dense_matches_cpu(cuda):
    """VGG's head: flatten of an NHWC tensor (H, W, C order), dense + relu,
    dense + softmax."""
    from repro_torch.core import TensorSpec
    from repro_torch.models.cnn_zoo import ZooGraph

    def graph(device):
        g = ZooGraph("head", torch.device(device), 0)
        prev = g.input(TensorSpec((2, 3, 3, 8), torch.float32))
        prev = g.add(g.flatten(), [prev])
        prev = g.add(g.dense("fc", 72, 40, act="relu"), [prev])
        g.add(g.dense("pred", 40, 10, act="softmax"), [prev])
        g.trace()
        return g

    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 3, 3, 8)).astype(np.float32))
    outs = []
    for dev in ("cpu", cuda):
        h = x.to(dev)
        for node in graph(dev).nodes[1:]:
            h = node.apply(h)
        outs.append(h)
    assert _rel(outs[1], outs[0]) <= ZOO_LAYER_TOL


def test_zoo_build_on_cuda_traces_like_meta(cuda):
    g = cnn_zoo.build("MobileNetV2", cuda)
    meta = cnn_zoo.build("MobileNetV2", "meta")
    assert [n.out_spec for n in g.nodes] == [n.out_spec for n in meta.nodes]
    assert all(p.device.type == "cuda" for p in g.modules.parameters())
    assert [b.node_ids for b in fuse_blocks(g)] == \
        [b.node_ids for b in fuse_blocks(meta)]


def test_zoo_block_launches_no_kernel_and_copies_no_layout(cuda):
    """A ResNet50 block (1x1/3x3 convs, a residual add) launches none of the
    hand-written kernels, and no operator copies a tensor into another
    layout (no aten::contiguous, clone or copy_ under it)."""
    from torch.profiler import ProfilerActivity, profile
    g = cnn_zoo.build("ResNet50", cuda)
    blk = fuse_blocks(g)[3]
    fn = blk.make_callable()
    x = torch.randn(blk.in_spec.shape, device=cuda)
    fn(x)
    torch.cuda.synchronize()
    before = _counts(*LAUNCHES)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn(x)
        torch.cuda.synchronize()
    assert _counts(*LAUNCHES) == before
    names = {e.name for e in prof.events()}
    assert not names & {"aten::contiguous", "aten::clone", "aten::copy_"}, \
        sorted(names)


# -- timing on the card: replays of a block captured in a CUDA graph --------
def _capture_case(kind, device):
    """A graph and the index of a block of it: a zoo block, or the block of
    one hand-written kernel in the prefill or decode graph at small widths."""
    from repro_torch.kernel_graph import decode_graph, kernel_graph
    gen = torch.Generator().manual_seed(0)
    if kind == "zoo":
        return cnn_zoo.build("MobileNetV2", device), 3
    if kind in ("flash", "ssd"):
        weights = {n: (torch.randn(64, 64, generator=gen) * 0.1)
                   .to(device, torch.bfloat16) for n in ("mlp0", "mlp1")}
        g = kernel_graph(TensorSpec((1, 256, 4, 64), torch.bfloat16), weights,
                         state_dim=16, device=device)
        kernel = "flash_attention" if kind == "flash" else "ssd_scan"
    else:
        weights = {n: (torch.randn(128, 128, generator=gen) * 0.1)
                   .to(device, torch.bfloat16) for n in ("mlp0", "mlp1")}
        g = decode_graph(TensorSpec((4, 8, 128), torch.bfloat16), weights,
                         cache_len=512, kv_heads=2, head_dim=128,
                         device=device)
        kernel = "decode_attention"
    blk = next(b for b in fuse_blocks(g)
               if any(g.nodes[i].kernel == kernel for i in b.node_ids))
    return g, blk.index


@pytest.mark.parametrize("kind", ["zoo", "flash", "ssd", "decode"])
def test_captured_block_replays_like_an_eager_call(cuda, kind):
    """The capture TimingProvider times: replaying it gives the eager call's
    output bit for bit, and the kernel's launch is counted at capture."""
    from repro_torch._device import capture
    g, index = _capture_case(kind, cuda)
    blk = fuse_blocks(g)[index]
    fn = blk.make_callable()
    x = _randn(np.random.default_rng(2), blk.in_spec.shape,
               blk.in_spec.dtype, cuda)
    want = fn(x)
    counts = _counts(*LAUNCHES)
    graph, got = capture(fn, (x,), cuda)
    after = _counts(*LAUNCHES)
    assert sum(after) - sum(counts) == (0 if kind == "zoo" else 1)
    graph.replay()
    graph.replay()
    torch.cuda.synchronize()
    assert _counts(*LAUNCHES) == after
    assert torch.equal(got, want)
    graph.reset()


def test_timing_provider_gives_reproducible_mobilenetv2_dbs(cuda):
    """Two fresh DBs of MobileNetV2 on the five tiers: each tier's time (its
    block times over its speed factor) agrees within 5%, the bound of
    chip_smoke.py's zoo phase."""
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from benchmarks import common_torch as ct
    graph = cnn_zoo.build("MobileNetV2", cuda)
    tiers = []
    for _ in range(2):
        s = ct.scission_for("3g", device=cuda)
        tiers.append(ct.tier_times(s.benchmark(graph), s.resources))
    for name, t in tiers[0].items():
        assert abs(t - tiers[1][name]) <= 0.05 * min(t, tiers[1][name]), \
            tiers


def test_block_that_cannot_be_captured_raises(cuda):
    """A block that syncs with the host cannot be captured: the
    TimingProvider and the autotuner raise, and time nothing eagerly."""
    from repro_torch.core import (LayerNode, Resource, TimingProvider,
                                  linear_graph)
    from repro_torch.core.resources import CLOUD_VM
    from repro_torch.kernels import KernelAutotuner
    calls = []

    def host_sync(x):
        calls.append(1)
        if x.is_meta:                     # shape tracing
            return x
        return x * x.sum().item()

    g = linear_graph("sync", TensorSpec((4, 8), torch.float32),
                     [LayerNode("sync", "dense", apply=host_sync)])
    blk = fuse_blocks(g)[-1]
    res = Resource("cloud", "cloud", CLOUD_VM)
    calls.clear()
    with pytest.raises(RuntimeError):
        TimingProvider(device=cuda).measure(blk, res, runs=3)
    assert len(calls) == 2               # the warm-up and the capture
    x = torch.ones(4, 8, device=cuda)
    with pytest.raises(RuntimeError):
        KernelAutotuner(device=cuda)._time_candidate(host_sync, (x,))
    assert torch.equal(x + 1, torch.full((4, 8), 2.0, device=cuda))


def _draws(device):
    """The default CUDA generator draws, and its draws follow its seed."""
    torch.manual_seed(5)
    a = torch.randn(1000, device=device)
    torch.manual_seed(5)
    assert torch.equal(a, torch.randn(1000, device=device))
    assert torch.isfinite(a).all() and a.std() > 0.5


def test_default_generator_draws_after_captures_and_block_timing(cuda):
    """After a successful capture and replays, after a capture whose body
    raises, and after the TimingProvider and the autotuner have timed a
    block, ``torch.randn(..., device="cuda")`` still draws from the
    default generator."""
    from repro_torch._device import capture, replay_seconds
    from repro_torch.core import (LayerNode, Resource, TimingProvider,
                                  linear_graph)
    from repro_torch.core.resources import CLOUD_VM
    from repro_torch.kernels import KernelAutotuner
    x = torch.ones(64, 64, device=cuda)
    x @ x                       # the warm-up every timer runs first
    _draws(cuda)
    assert len(replay_seconds(lambda t: t @ t, (x,), 3, cuda)) == 3
    _draws(cuda)

    def fails(t):
        t = t * 2
        raise ValueError("the body raises mid-capture")

    with pytest.raises(ValueError):
        capture(fails, (x,), cuda)
    _draws(cuda)
    with pytest.raises(RuntimeError):          # a host sync mid-capture
        capture(lambda t: t * t.sum().item(), (x,), cuda)
    _draws(cuda)

    g = linear_graph("dense", TensorSpec((4, 64), torch.float32),
                     [LayerNode("dense", "dense",
                                apply=lambda t: torch.tanh(t @ x))])
    blk = fuse_blocks(g)[-1]
    TimingProvider(device=cuda).measure(
        blk, Resource("cloud", "cloud", CLOUD_VM), runs=3)
    KernelAutotuner(device=cuda)._time_candidate(lambda t: t @ t, (x,))
    _draws(cuda)


# -- the LM models and the serving engine on the card --------------------------
LM_SMALL = dict(d_model=64, n_heads=4, head_dim=16, d_ff=128, vocab=128,
                ssm_state=16, ssm_head_dim=16, ssm_chunk=16, window=16)
# the published Zamba2's shared blocks at irregular positions of 9 layers
HYBRID_SMALL = dict(n_layers=9, hybrid_layer_ids=(1, 3, 6, 8),
                    shared_adapter_rank=4)


def _small_lm(arch, device, **extra):
    from repro_torch.models import build_model, get_config
    cfg = get_config(arch)
    n_layers = cfg.shared_attn_period * 2 if cfg.shared_attn_period \
        else len(cfg.pattern) * 2
    if cfg.hybrid_layer_ids:
        n_layers = HYBRID_SMALL["n_layers"]
        extra = {**HYBRID_SMALL, **extra}
    kv = 4 if cfg.n_kv_heads == cfg.n_heads else 2
    cfg = cfg.replace(n_layers=n_layers, n_kv_heads=kv,
                      query_pre_attn_scalar=16.0
                      if cfg.query_pre_attn_scalar else None,
                      **{k: v for k, v in {**LM_SMALL, **extra}.items()
                         if k not in ("window", "n_layers") or
                         (k == "window" and cfg.window)})
    return build_model(cfg, device=device)


# the kernels each small model's steps launch
LM_KERNELS = {"granite-8b": {"flash", "decode"}, "gemma2-9b": {"flash",
                                                               "decode"},
              "zamba2-2.7b": {"flash", "ssd", "decode"},
              "zamba2-7b": {"flash", "ssd", "decode"},
              "qwen2-moe-a2.7b": {"flash", "decode"}, "xlstm-125m": {"ssd"}}


@pytest.mark.parametrize("arch", ["granite-8b", "gemma2-9b", "zamba2-2.7b",
                                  "zamba2-7b", "qwen2-moe-a2.7b",
                                  "xlstm-125m"])
def test_lm_steps_on_the_card_match_the_cpu(cuda, arch):
    """fp32: forward, prefill and ragged decode steps on the card (fp32
    kernels, TF32 off) against the CPU (the plain versions): forward at
    1e-3 absolute plus relative; past a cache by relative norm error at
    1e-3, since the bf16 caches can round a k (or a conv state) the two
    compute a float32 ulp apart to neighbouring bf16 values.  The
    published Zamba2's four shared applications each read K and V back
    from the cache, so such roundings compound past 1e-3 (1.4e-3 seen):
    its caches are held in fp32, which removes them.  Every kernel of the
    model's path launches."""
    from repro_torch.models import layers as L
    cpu = _small_lm(arch, "cpu")
    card = _small_lm(arch, cuda)
    params = cpu.init(seed=0, dtype=torch.float32)
    dparams = L.tree_map(lambda a: a.to(cuda), params)
    rng = np.random.default_rng(12)
    tokens = torch.from_numpy(rng.integers(0, 128, (2, 32), dtype=np.int32))
    counts = _counts(*LAUNCHES)
    tol = dict(rtol=1e-3, atol=1e-3)
    want, _ = cpu.forward(params, tokens)
    got, _ = card.forward(dparams, tokens.to(cuda))
    _close(got.cpu(), want, tol)
    caches = [m.init_cache(batch=2, max_len=48) for m in (cpu, card)]
    if cpu.cfg.hybrid_layer_ids:
        caches = [L.tree_map(lambda t: t.float(), c) for c in caches]
    want, _ = cpu.prefill(params, tokens, caches[0])
    got, _ = card.prefill(dparams, tokens.to(cuda), caches[1])
    assert _rel(got, want) <= 1e-3
    clen = torch.tensor([32, 20], dtype=torch.int32)
    for _ in range(3):
        tok = torch.from_numpy(rng.integers(0, 128, (2, 1), dtype=np.int32))
        want, _ = cpu.decode_step(params, tok, caches[0], clen)
        got, _ = card.decode_step(dparams, tok.to(cuda), caches[1],
                                  clen.to(cuda))
        assert _rel(got, want) <= 1e-3
        clen += 1
    launched = {k for k, before, after in zip(
        ("flash", "ssd", "decode"), counts, _counts(*LAUNCHES))
        if after > before}
    assert launched == LM_KERNELS[arch]


@pytest.mark.parametrize("arch", ["gemma2-9b", "zamba2-2.7b", "zamba2-7b",
                                  "qwen2-moe-a2.7b", "xlstm-125m",
                                  "granite-8b"])
def test_engine_on_the_card_gives_the_cpu_tokens(cuda, arch):
    """fp32: the engine on the card yields the CPU engine's greedy tokens,
    on the bucketed path (gemma2, whose local layers' window of 16 the
    sequences outgrow; qwen2-moe; granite at width 4) and the exact one
    (zamba2, xlstm).  On the card the decode steps replay CUDA graphs."""
    from repro_torch.models import layers as L
    from repro_torch.serving import Request, ServingEngine
    cpu = _small_lm(arch, "cpu")
    card = _small_lm(arch, cuda)
    params = cpu.init(seed=1, dtype=torch.float32)
    dparams = L.tree_map(lambda a: a.to(cuda), params)
    rng = np.random.default_rng(13)
    prompts = [rng.integers(0, 128, n) for n in (16, 8, 32, 16, 4)]
    tokens = []
    width = 4 if arch == "granite-8b" else 2
    for model, p in ((cpu, params), (card, dparams)):
        eng = ServingEngine(model, p, width=width, max_len=64)
        for i, prompt in enumerate(prompts):
            eng.submit(Request(rid=i, prompt=prompt, max_new_tokens=12))
        eng.warmup()
        replays = _counted("decode_graph_replays")
        tokens.append([r.tokens for r in sorted(eng.run(),
                                                key=lambda r: r.rid)])
    assert tokens[0] == tokens[1]
    assert _counted("decode_graph_replays") > replays


def _zero_slot(cache, slot):
    """A re-admitted slot's recurrent state zeroed (batch is axis 1 of
    every leaf); its K/V rows past the new length are stale, as in the
    engine's pool."""
    for sub in cache.values():
        for key, leaf in sub.items():
            if key not in ("k", "v"):
                for t in (leaf if isinstance(leaf, tuple) else (leaf,)):
                    t[:, slot].zero_()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("arch", ["granite-8b", "zamba2-2.7b", "zamba2-7b",
                                  "qwen2-moe-a2.7b"])
def test_graphed_decode_step_gives_the_eager_steps_tokens(cuda, arch, dtype):
    """64 ragged ticks of ``make_decode_step`` (CUDA graphs cut at each
    ``decode_attention`` launch) against ``model.decode_step`` + argmax on
    a copy of the same cache, fed the same tokens, with a slot released
    and re-admitted every 8 ticks: equal tokens, logits within the
    engine's 3e-2, the caller's cache handed back; each tick launches the
    eager step's ``decode_attention`` calls, all through the name
    ``layers.decode_attention``, and replays once; the SSD decode kernel
    is captured in the chain (its launches counted at capture only); one
    capture, and one more for a second cache."""
    from repro_torch.launch import steps
    from repro_torch.models import layers as L
    # the bf16 kernel takes head_dim 32 and up
    model = _small_lm(arch, cuda, head_dim=32)
    params = model.init(seed=5, dtype=dtype)
    B, max_len, ticks = 4, 96, 64
    rng = np.random.default_rng(21)
    cache = model.init_cache(B, max_len)
    prompt = torch.from_numpy(rng.integers(0, 128, (B, 16), dtype=np.int32))
    decode = steps.make_decode_step(model)
    lengths = np.array([16, 9, 3, 12], np.int32)
    tok = rng.integers(0, 128, (B, 1)).astype(np.int32)
    captures = _counted("decode_graph_captures")
    real, seen = L.decode_attention, []

    def counted(*a, **kw):
        seen.append(kw.get("out") is not None)
        return real(*a, **kw)

    with torch.no_grad():
        _, cache = model.prefill(params, prompt.to(cuda), cache)
        eager = L.tree_map(torch.clone, cache)
        for t in range(ticks):
            if t and t % 8 == 0:
                slot = t // 8 % B
                lengths[slot] = rng.integers(1, 8)
                tok[slot] = rng.integers(0, 128)
                _zero_slot(cache, slot)
                _zero_slot(eager, slot)
            tt = torch.from_numpy(tok).to(cuda)
            ll = torch.from_numpy(lengths).to(cuda)
            launched, replays = _counts("decode_attention_launches",
                                        "decode_graph_replays")
            ssd_launched = _counted("ssd_decode_launches")
            L.decode_attention, seen[:] = counted, []
            try:
                got_tok, got_logits, out = decode(params, cache, tt, ll)
            finally:
                L.decode_attention = real
            graphed = _counted("decode_attention_launches") - launched
            ssd_graphed = _counted("ssd_decode_launches") - ssd_launched
            want_logits, eager = model.decode_step(params, tt, eager, ll)
            # the SSD decode launches once a Mamba-2 layer in the eager step
            # and in the capture (the first tick runs both), never in a
            # replay
            ssd_eager = _counted("ssd_decode_launches") - ssd_launched - \
                ssd_graphed
            assert ssd_graphed == (2 * ssd_eager if t == 0 else 0)
            assert (ssd_eager > 0) == arch.startswith("zamba2")
            want_tok = torch.argmax(want_logits[:, -1], dim=-1) \
                .to(torch.int32)[:, None]
            assert graphed == _counted("decode_attention_launches") - \
                launched - graphed > 0
            assert seen == [t > 0] * graphed
            assert _counted("decode_graph_replays") - replays == \
                (1 if t else 0)
            assert out is cache
            assert torch.equal(got_tok, want_tok), t
            assert _rel(got_logits, want_logits.cpu()) <= 3e-2, t
            tok = want_tok.cpu().numpy()
            lengths += 1
        assert _counted("decode_graph_captures") == captures + 1
        other = L.tree_map(torch.clone, cache)
        tracing.start()
        try:
            for _ in range(2):
                decode(params, other, tt, ll)
        finally:
            tracing.stop()
    assert _counted("decode_graph_captures") == captures + 2
    recs = [r for r in tracing.spans() if r["name"] == "step.decode"]
    tracing.clear()
    assert [r["attrs"] for r in recs[-2:]] == [{"graphed": False},
                                               {"graphed": True}]


def test_lm_at_head_dim_256_fits_the_card(cuda):
    """bf16 at head_dim 256 (the gemma configs'): the default flash and
    decode block sizes do not fit the card's shared memory, so the
    wrappers launch smaller ones; forward, prefill and decode against the CPU's
    plain versions on the same bf16 weights, by relative norm error at
    3e-2."""
    from repro_torch.models import build_model, get_config
    from repro_torch.models import layers as L
    cfg = get_config("gemma2-9b").replace(
        n_layers=2, d_model=256, d_ff=512, vocab=256, window=32)
    cpu, card = build_model(cfg, device="cpu"), build_model(cfg, device=cuda)
    params = cpu.init(seed=2)
    dparams = L.tree_map(lambda a: a.to(cuda), params)
    tokens = torch.from_numpy(np.random.default_rng(14).integers(
        0, 256, (2, 64), dtype=np.int32))

    counts = _counts("flash_attention_launches", "decode_attention_launches")
    assert _rel(card.forward(dparams, tokens.to(cuda))[0],
                cpu.forward(params, tokens)[0]) <= 3e-2
    caches = [m.init_cache(batch=2, max_len=96) for m in (cpu, card)]
    want, _ = cpu.prefill(params, tokens, caches[0])
    got, _ = card.prefill(dparams, tokens.to(cuda), caches[1])
    assert _rel(got, want) <= 3e-2
    clen = torch.tensor([64, 50], dtype=torch.int32)
    tok = torch.tensor([[1], [2]], dtype=torch.int32)
    want, _ = cpu.decode_step(params, tok, caches[0], clen)
    got, _ = card.decode_step(dparams, tok.to(cuda), caches[1], clen.to(cuda))
    assert _rel(got, want) <= 3e-2
    assert all(a > b for a, b in zip(
        _counts("flash_attention_launches", "decode_attention_launches"),
        counts))


def test_xlstm_at_its_full_head_width_on_the_card(cuda):
    """bf16 xlstm-125m at its full widths (d_model 768, 4 heads: the
    mLSTM's 384-wide heads take ssd_scan's wide route), two layers:
    forward, prefill and a decode step against the CPU's plain versions on
    the same weights, by relative norm error at 3e-2."""
    from repro_torch.models import build_model, get_config
    from repro_torch.models import layers as L
    cfg = get_config("xlstm-125m").replace(n_layers=2, vocab=512)
    cpu, card = build_model(cfg, device="cpu"), build_model(cfg, device=cuda)
    params = cpu.init(seed=3)
    dparams = L.tree_map(lambda a: a.to(cuda), params)
    tokens = torch.from_numpy(np.random.default_rng(16).integers(
        0, 512, (2, 256), dtype=np.int32))
    before = _counted("ssd_scan_launches")
    assert _rel(card.forward(dparams, tokens.to(cuda))[0],
                cpu.forward(params, tokens)[0]) <= 3e-2
    caches = [m.init_cache(batch=2, max_len=300) for m in (cpu, card)]
    want, _ = cpu.prefill(params, tokens, caches[0])
    got, _ = card.prefill(dparams, tokens.to(cuda), caches[1])
    assert _rel(got, want) <= 3e-2
    clen = torch.tensor([256, 256], dtype=torch.int32)
    tok = torch.tensor([[1], [2]], dtype=torch.int32)
    want, _ = cpu.decode_step(params, tok, caches[0], clen)
    got, _ = card.decode_step(dparams, tok.to(cuda), caches[1], clen.to(cuda))
    assert _rel(got, want) <= 3e-2
    assert _counted("ssd_scan_launches") == before + 2  # forward, prefill


def test_encdec_on_the_card_matches_the_cpu(cuda):
    """fp32 whisper-medium cut to 2 + 2 layers of its full width (16 heads
    of 64) over 300 frames: encode (non-causal flash), prefill (causal
    flash, cross-attention as non-causal flash with Sq != Sk) and ragged
    decode steps (decode attention over the self cache, and over the cross
    cache at length 300 for every row) against the CPU, by relative norm
    error at 1e-3 (the bf16 caches)."""
    from repro_torch.models import build_model, get_config, vision
    from repro_torch.models import layers as L
    cfg = get_config("whisper-medium").replace(
        n_layers=2, encoder_layers=2, encoder_len=300, vocab=512)
    cpu, card = build_model(cfg, device="cpu"), build_model(cfg, device=cuda)
    params = cpu.init(seed=4, dtype=torch.float32)
    dparams = L.tree_map(lambda a: a.to(cuda), params)
    frames = vision.synthetic_embeds(
        5, vision.frame_embed_spec(2, 300, cfg.d_model), device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(17).integers(
        0, 512, (2, 8), dtype=np.int32))
    counts = _counts("flash_attention_launches", "decode_attention_launches")
    assert _rel(card.encode(dparams, frames.to(cuda)),
                cpu.encode(params, frames)) <= 1e-3
    caches = [m.init_cache(batch=2, max_len=24) for m in (cpu, card)]
    want, _ = cpu.prefill(params, tokens, caches[0], frames=frames)
    got, _ = card.prefill(dparams, tokens.to(cuda), caches[1],
                          frames=frames.to(cuda))
    assert _rel(got, want) <= 1e-3
    clen = torch.tensor([8, 5], dtype=torch.int32)
    for i in range(3):
        tok = torch.tensor([[i], [i + 1]], dtype=torch.int32)
        want, _ = cpu.decode_step(params, tok, caches[0], clen)
        got, _ = card.decode_step(dparams, tok.to(cuda), caches[1],
                                  clen.to(cuda))
        assert _rel(got, want) <= 1e-3
        clen += 1
    assert all(a > b for a, b in zip(
        _counts("flash_attention_launches", "decode_attention_launches"),
        counts))


# -- the analysis passes on the card ---------------------------------------------
def test_verify_smem_holds_the_analysis_at_the_paths_shapes(cuda):
    """Every candidate the shared-memory and tiling analyses admit at the
    paths' full-width shapes launches (the C entry points refuse any other
    footprint figure), and each one they prune is refused with the same
    byte count or reason."""
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from benchmarks import bench_autotune_torch as ba

    report = ba.verify_smem(cuda)
    assert report["limit_bytes"] == card_smem_limit(cuda)
    cands = [c for e in report["kernels"] for c in e["candidates"]]
    assert all(c["agrees"] for c in cands), [c for c in cands
                                             if not c["agrees"]]
    assert any(not c["admitted"] for c in cands)
    assert all(c["launched"] == c["admitted"] for c in cands)
    assert all(e["static_smem"] + c["smem_bytes"] <= report["limit_bytes"]
               for e in report["kernels"] for c in e["candidates"]
               if c["admitted"])


def test_lint_cli_reads_the_cards_limit(cuda, capsys):
    from repro_torch.analysis.cli import main
    from repro_torch.analysis.kernel_smem import H100_SMEM_PER_BLOCK
    limit = card_smem_limit(cuda)
    assert main(["--strict", "kernels", "tiling"]) == 0
    assert f"(limit {limit} B)" in capsys.readouterr().out
    if "H100" in torch.cuda.get_device_name(cuda):
        assert limit == H100_SMEM_PER_BLOCK


def test_fx_lint_captures_kernel_blocks_on_the_card(cuda):
    """SCN503 on the card: the demo graph's kernel-bearing blocks capture;
    a kernel-bearing block that reads a value back to the host traces on
    meta but cannot be captured."""
    from repro_torch.analysis.fx_lint import lint_blocks
    from repro_torch.core import LayerNode, linear_graph
    from repro_torch.kernels.ops import flash_attention_node, ssd_scan_node

    g = linear_graph("demo", TensorSpec((1, 256, 4, 80), torch.bfloat16),
                     [flash_attention_node("attn", device=cuda),
                      ssd_scan_node("ssd", state_dim=64, device=cuda)])
    launched = _counts("flash_attention_launches", "ssd_scan_launches")
    assert lint_blocks(fuse_blocks(g), device=cuda) == []
    assert all(a > b for a, b in zip(
        _counts("flash_attention_launches", "ssd_scan_launches"), launched))

    def host_read(x):
        if x.is_meta:
            return x
        return x * x.sum().item()

    g = linear_graph("sync", TensorSpec((4, 8), torch.float32),
                     [LayerNode("k", "attention", apply=host_read,
                                kernel="flash_attention")])
    diags = lint_blocks(fuse_blocks(g), device=cuda)
    assert [(d.code, d.severity) for d in diags] == [("SCN503", "error")]
    assert "cannot be captured" in diags[0].message
    assert lint_blocks(fuse_blocks(g)) == []        # meta alone: clean
    assert torch.equal(torch.ones(2, device=cuda) + 1,
                       torch.full((2,), 2.0, device=cuda))


# -- training on the card: the kernels' autograd Functions ------------------
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mask", [dict(causal=True),
                                  dict(causal=True, window=40, softcap=20.0),
                                  dict(causal=False)], ids=str)
def test_flash_gradients_through_the_kernel(cuda, dtype, mask):
    """With grad mode on and inputs that require grad, the wrapper launches
    the kernel forward and its backward is the plain version's gradient:
    every one of q, k, v gets it (none is cut)."""
    rng = np.random.default_rng(40)
    q, k, v = (_randn(rng, s, dtype, cuda).requires_grad_()
               for s in ((2, 160, 4, 64), (2, 160, 2, 64), (2, 160, 2, 64)))
    before = _counts("flash_attention_launches",
                     "flash_attention_backward_launches")
    o = fa_mod.flash_attention(q, k, v, **mask)
    assert o.grad_fn is not None
    go = _randn(rng, o.shape, dtype, cuda)
    got = torch.autograd.grad(o, (q, k, v), go)
    assert _counts("flash_attention_launches",
                   "flash_attention_backward_launches") == \
        (before[0] + 1, before[1] + 1)
    _close(o, flash_attention_ref(q, k, v, **mask), TOL[dtype])
    want = torch.autograd.grad(flash_attention_ref(q, k, v, **mask),
                               (q, k, v), go)
    for g, w in zip(got, want):
        assert g.dtype == dtype and g.abs().sum() > 0
        _close(g, w, TOL[dtype])


@pytest.mark.parametrize("dtype,S,H,P,N,chunk", [
    (torch.float32, 96, 4, 32, 16, 32),
    (torch.bfloat16, 256, 4, 64, 64, 64),
    (torch.bfloat16, 256, 2, 384, 384, 128),       # the wide route
])
def test_ssd_gradients_through_the_kernel(cuda, dtype, S, H, P, N, chunk):
    """As models/ssm.py calls it: log_a in fp32, head-shared b, c as
    stride-0 views, whose gradients sum over the heads; a loss on y and
    on the final state."""
    rng = np.random.default_rng(41)
    x = _randn(rng, (2, S, H, P), dtype, cuda).requires_grad_()
    b1, c1 = ((_randn(rng, (2, S, 1, N), dtype, cuda) * N ** -0.5)
              .requires_grad_() for _ in range(2))
    la = torch.from_numpy(-rng.random((2, S, H), dtype=np.float32)).to(
        cuda).requires_grad_()
    inputs = (x, la, b1, c1)

    def loss(fn):
        y, final = fn(x, la, b1.expand(2, S, H, N), c1.expand(2, S, H, N),
                      chunk=chunk)
        return y.float().square().mean() + final.square().mean(), y

    before = _counts("ssd_scan_launches", "ssd_scan_backward_launches")
    out, y = loss(ssd_mod.ssd_scan)
    got = torch.autograd.grad(out, inputs)
    assert _counts("ssd_scan_launches", "ssd_scan_backward_launches") == \
        (before[0] + 1, before[1] + 1)
    ref_out, y_ref = loss(ssd_ref)
    _close(y, y_ref, SSD_TOL[dtype])
    want = torch.autograd.grad(ref_out, inputs)
    for g, w in zip(got, want):
        assert g.abs().sum() > 0
        _close(g, w, SSD_TOL[dtype])


def test_backward_spans_time_the_device(cuda):
    """The Functions' backward spans open on autograd's device thread, as
    roots of its own, and get a positive CUDA-event time; the wrappers'
    forward spans stay on the calling thread, with no events."""
    rng = np.random.default_rng(43)
    q, k, v = (_randn(rng, s, torch.bfloat16, cuda).requires_grad_()
               for s in ((1, 512, 4, 64), (1, 512, 2, 64), (1, 512, 2, 64)))
    x = _randn(rng, (1, 512, 4, 64), torch.bfloat16, cuda).requires_grad_()
    b, c = (_randn(rng, (1, 512, 4, 64), torch.bfloat16, cuda)
            .requires_grad_() for _ in range(2))
    la = torch.from_numpy(-rng.random((1, 512, 4), dtype=np.float32)).to(
        cuda).requires_grad_()
    tracing.clear()
    tracing.start()
    try:
        o = fa_mod.flash_attention(q, k, v)
        torch.autograd.grad(o.float().square().sum(), (q, k, v))
        y, final = ssd_mod.ssd_scan(x, la, b, c, chunk=64)
        torch.autograd.grad(y.float().square().sum() + final.sum(),
                            (x, la, b, c))
    finally:
        tracing.stop()
    recs = {r["name"]: r for r in tracing.spans()}
    tracing.clear()
    assert set(recs) == {"kernel.flash_attention", "kernel.ssd_scan",
                         "kernel.flash_attention.backward",
                         "kernel.ssd_scan.backward"}
    here = threading.get_ident()
    for name in ("kernel.flash_attention", "kernel.ssd_scan"):
        assert recs[name]["thread"] == here
        assert recs[name]["device_s"] is None
    for name in ("kernel.flash_attention.backward",
                 "kernel.ssd_scan.backward"):
        assert recs[name]["thread"] != here
        assert recs[name]["parent"] is None
        assert recs[name]["device_s"] > 0


def test_chip_smoke_profiler_readers_count_kernels_not_spans(cuda):
    """Under the profiler each wrapper's span also appears as a device-side
    user annotation; chip_smoke's kernel_trace and device_busy_ms count
    the kernels alone, so a call reads the same with the span as without."""
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    rng = np.random.default_rng(44)
    q = _randn(rng, (4, 8, 128), torch.bfloat16, cuda)
    k, v = (_randn(rng, (4, 1024, 2, 128), torch.bfloat16, cuda)
            for _ in range(2))
    lengths = torch.full((4,), 1024, dtype=torch.int32, device=cuda)

    def call():
        return da_mod.decode_attention(q, k, v, lengths)
    trace = chip_smoke.kernel_trace(call, calls=5)
    assert trace and not any(n.startswith(tracing.PREFIX)
                             for n in trace["kernel_ms"]), trace
    # an annotation over the kernels would double the call's busy time
    assert chip_smoke.device_busy_ms(call) == pytest.approx(
        trace["sum_ms"], rel=0.3)


def test_decode_attention_refuses_input_that_requires_grad(cuda):
    rng = np.random.default_rng(42)
    q = _randn(rng, (2, 4, 64), torch.float32, cuda).requires_grad_()
    k = v = _randn(rng, (2, 32, 2, 64), torch.float32, cuda)
    lengths = torch.tensor([5, 32], dtype=torch.int32, device=cuda)
    before = _counted("decode_attention_launches")
    with pytest.raises(ValueError, match="no backward"):
        da_mod.decode_attention(q, k, v, lengths)
    assert _counted("decode_attention_launches") == before
    with torch.no_grad():
        da_mod.decode_attention(q, k, v, lengths)
    assert _counted("decode_attention_launches") == before + 1


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "xlstm-125m",
                                  "qwen2-moe-a2.7b", "whisper-medium",
                                  "internvl2-76b"])
def test_train_step_on_the_card_matches_the_cpu(cuda, arch):
    """fp32: one train step on the card (fp32 kernels forward, the plain
    backward, TF32 off) against the CPU: the loss within 1e-3 relative (the
    forward's tolerance above), the whole update within 1e-2 relative L2;
    each kernel of the path launches in both directions.  The MoE's aux
    loss, whisper's frames (non-causal and cross flash, Sq != Sk) and
    internvl2's patch embeddings (the -1-labelled image prefix) train
    too, at reduced depth."""
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import build_model, get_config
    from repro_torch.models import layers as L
    from repro_torch.optim import AdamWConfig, init_state
    if arch == "whisper-medium":
        cfg = get_config(arch).replace(n_layers=2, encoder_layers=2,
                                       encoder_len=96, vocab=128)
        cpu, card = (build_model(cfg, device=d) for d in ("cpu", cuda))
    else:
        cpu, card = _small_lm(arch, "cpu"), _small_lm(arch, cuda)
        if arch == "internvl2-76b":
            cfg = cpu.cfg.replace(n_img_tokens=8)
            cpu, card = (build_model(cfg, device=d) for d in ("cpu", cuda))
    params = cpu.init(seed=2, dtype=torch.float32)
    start = [p.clone() for p in L.tree_leaves(params)]
    dparams = L.tree_map(lambda a: a.to(cuda), params)
    rng = np.random.default_rng(14)
    batch = {k: torch.from_numpy(rng.integers(0, 128, (2, 32),
                                              dtype=np.int32))
             for k in ("tokens", "labels")}
    c = cpu.cfg
    if c.is_encdec:
        batch["frames"] = _randn(rng, (2, c.encoder_len, c.d_model),
                                 torch.float32, "cpu")
    if c.n_img_tokens:
        batch["patch_embeds"] = _randn(rng, (2, c.n_img_tokens, c.d_model),
                                       torch.float32, "cpu")
    cfg = AdamWConfig(lr=1e-2)
    counts = _counts("flash_attention_backward_launches",
                     "ssd_scan_backward_launches")
    _, _, want = make_train_step(cpu, cfg)(params, init_state(params), batch)
    _, _, got = make_train_step(card, cfg)(
        dparams, init_state(dparams), {k: v.to(cuda) for k, v in
                                       batch.items()})
    assert abs(got["loss"].item() - want["loss"].item()) <= \
        1e-3 * abs(want["loss"].item())
    moved = [(d.cpu() - s, p - s) for d, p, s in zip(
        L.tree_leaves(dparams), L.tree_leaves(params), start)]
    err = sum((a - b).square().sum() for a, b in moved).sqrt()
    assert err <= 1e-2 * sum(b.square().sum() for _, b in moved).sqrt()
    if c.moe_experts:
        assert got["aux"].item() > 0 and abs(
            got["aux"].item() - want["aux"].item()) <= \
            1e-3 * abs(want["aux"].item())
    if arch in ("zamba2-2.7b", "xlstm-125m"):
        assert _counted("ssd_scan_backward_launches") > counts[1]
    if arch != "xlstm-125m":
        assert _counted("flash_attention_backward_launches") > counts[0]


def test_checkpoint_saved_on_the_card_restores_on_the_cpu(cuda, tmp_path):
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.models import layers as L
    rng = np.random.default_rng(43)
    tree = {"p": {"w": _randn(rng, (64, 32), torch.bfloat16, cuda),
                  "b": _randn(rng, (32,), torch.float32, cuda)},
            "step": torch.tensor(7, dtype=torch.int32, device=cuda)}
    mgr = CheckpointManager(str(tmp_path), keep=1)
    mgr.save(7, tree)
    mgr.wait()
    like = L.tree_map(lambda t: t.cpu(), tree)
    got, step, _ = mgr.restore_latest(like)
    assert step == 7
    for g, w in zip(L.tree_leaves(got), L.tree_leaves(tree)):
        assert g.device.type == "cpu" and g.dtype == w.dtype
        assert torch.equal(g, w.cpu())


# -- the sharded steps on a 1 x 1 mesh of the card ----------------------------
def _local_leaves(tree):
    from repro_torch.models import layers as L
    return [t.to_local() if hasattr(t, "to_local") else t
            for t in L.tree_leaves(tree)]


def test_sharded_train_step_on_a_1x1_mesh_equals_the_unsharded(cuda):
    """fp32 zamba2 (reduced, remat, loss chunks): two sharded train steps
    on a 1 x 1 ``DeviceMesh`` of the card give the unsharded steps' losses
    and parameters bit for bit, and flash and the SSD launch inside the
    mesh (``local_map``), forward and backward."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.launch.steps import make_train_step, rules_for, \
        shard_args
    from repro_torch.optim import AdamWConfig, init_state
    model = _small_lm("zamba2-2.7b", cuda)
    model.cfg = model.cfg.replace(remat=True, loss_seq_chunk=16)
    rng = np.random.default_rng(15)
    batch = {k: torch.from_numpy(rng.integers(0, 128, (2, 32),
                                              dtype=np.int32)).to(cuda)
             for k in ("tokens", "labels")}
    shape = ShapeConfig("t", 32, 2, "train")
    rules = rules_for(shape, multi_pod=False)
    mesh = make_smoke_mesh(cuda)
    runs = []
    for sharded in (False, True):
        params = model.init(seed=3, dtype=torch.float32)
        args = {"params": params, "opt_state": init_state(params),
                "batch": batch}
        kw = {}
        if sharded:
            args = shard_args(model.cfg, shape, mesh, rules, args)
            kw = dict(rules=rules, mesh=mesh)
        step = make_train_step(model, AdamWConfig(lr=1e-2), **kw)
        counts = _counts(*TRAINED)
        losses = []
        for _ in range(2):
            args["params"], args["opt_state"], m = step(
                args["params"], args["opt_state"], args["batch"])
            losses.append(m["loss"])
        after = _counts(*TRAINED)
        assert all(a > b for a, b in zip(after, counts))
        runs.append((losses, _local_leaves(args["params"])))
    (l0, p0), (l1, p1) = runs
    assert all(torch.equal(a, b) for a, b in zip(l0, l1)), (l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(p0, p1))


@pytest.mark.parametrize("arch", ["granite-8b", "zamba2-2.7b"])
def test_sharded_serving_steps_on_a_1x1_mesh_equal_the_unsharded(cuda, arch):
    """fp32: the sharded prefill and four greedy decode steps (decode under
    ``rules_for(decode)``) on a 1 x 1 mesh of the card give the unsharded
    steps' logits and tokens bit for bit, through each kernel of the path."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.launch.steps import (make_decode_step,
                                          make_prefill_step, rules_for,
                                          shard_args)
    model = _small_lm(arch, cuda)
    mesh = make_smoke_mesh(cuda)
    B, S, max_len = 2, 16, 32
    pshape = ShapeConfig("p", max_len, B, "prefill")
    dshape = ShapeConfig("d", max_len, B, "decode")
    tokens = torch.from_numpy(np.random.default_rng(16).integers(
        0, 128, (B, S), dtype=np.int32)).to(cuda)
    runs = []
    for sharded in (False, True):
        params = model.init(seed=4, dtype=torch.float32)
        cache = model.init_cache(B, max_len)
        counts = _counts(*LAUNCHES)
        if sharded:
            pr, dr = (rules_for(s, multi_pod=False) for s in (pshape, dshape))
            a = shard_args(model.cfg, pshape, mesh, pr,
                           {"params": params, "cache": cache,
                            "batch": {"tokens": tokens}})
            params, cache, batch = a["params"], a["cache"], a["batch"]
            prefill = make_prefill_step(model, rules=pr, mesh=mesh)
            decode = make_decode_step(model, rules=dr, mesh=mesh)
        else:
            batch = {"tokens": tokens}
            prefill, decode = make_prefill_step(model), make_decode_step(model)
        with torch.no_grad():
            logits, cache = prefill(params, cache, batch)
            outs = [logits]
            tok = torch.argmax(outs[0][:, -1], dim=-1).to(torch.int32)[:, None]
            for i in range(4):
                clen = torch.tensor(S + i, dtype=torch.int32, device=cuda)
                args = {"token": tok.full_tensor() if sharded else tok,
                        "cache_len": clen}
                if sharded:
                    args = shard_args(model.cfg, dshape, mesh, dr, args)
                tok, logits, cache = decode(params, cache, args["token"],
                                            args["cache_len"])
                outs += [logits, tok]
        after = _counts(*LAUNCHES)
        launched = {k for k, b, a in zip(("flash", "ssd", "decode"), counts,
                                         after) if a > b}
        assert launched == LM_KERNELS[arch]
        runs.append([o.full_tensor() if hasattr(o, "full_tensor") else o
                     for o in outs])
    assert all(torch.equal(a, b) for a, b in zip(*runs))
