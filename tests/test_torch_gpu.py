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

import numpy as np
import pytest
import torch

from repro_torch.core import TensorSpec, fuse_blocks
from repro_torch.kernels import _build
from repro_torch.kernels import decode_attention as da_mod
from repro_torch.kernels import flash_attention as fa_mod
from repro_torch.kernels import ssd_scan as ssd_mod
from repro_torch.kernels.ref import (decode_attention_ref,
                                     flash_attention_ref, ssd_ref)
from repro_torch.kernels.substrate import card_smem_limit
from repro_torch.models import cnn_zoo

pytestmark = pytest.mark.gpu

TOL = {torch.float32: dict(rtol=2e-5, atol=2e-5),
       torch.bfloat16: dict(rtol=3e-2, atol=3e-2)}
SSD_TOL = {torch.float32: dict(rtol=2e-4, atol=2e-4),
           torch.bfloat16: dict(rtol=3e-2, atol=3e-2)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


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
    before = fa_mod.launches
    got = fa_mod.flash_attention(q, k, v, causal=causal, window=window,
                                 softcap=softcap, block_q=bq, block_k=bk)
    torch.cuda.synchronize()
    assert fa_mod.launches == before + 1
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
    before = fa_mod.launches
    with pytest.raises(ValueError, match="shared memory"):
        fa_mod.flash_attention(x, x, x, block_q=256, block_k=256)
    assert fa_mod.launches == before


def test_flash_attention_bf16_refuses_other_head_dims(cuda):
    """The tensor-core route takes head_dim % 16 == 0 up to 256; it never
    hands another shape to the plain version or the fp32 kernel."""
    before = fa_mod.launches
    for hd in (72, 272):
        x = torch.zeros((1, 64, 2, hd), device=cuda, dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="head_dim"):
            fa_mod.flash_attention(x, x, x)
    x = torch.zeros((1, 640, 2, 64), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="block_q"):
        fa_mod.flash_attention(x, x, x, block_q=512)
    assert fa_mod.launches == before
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
    before = ssd_mod.launches
    y, fin = ssd_mod.ssd_scan(x, log_a, b, c, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd_mod.launches == before + 1
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
])
@pytest.mark.parametrize("la_dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_bf16_wide_route_matches_plain(cuda, B, S, H, P, N, chunk,
                                                la_dtype):
    """P > 128 or N > 64: pass 1 tiled over the state, pass 3 streaming N
    in slabs of 64 over P tiles of 128."""
    rng = np.random.default_rng(12)
    x = _randn(rng, (B, S, H, P), torch.bfloat16, cuda)
    log_a = -torch.nn.functional.softplus(
        _randn(rng, (B, S, H), torch.float32, cuda)).to(la_dtype)
    b = (_randn(rng, (B, S, H, N), torch.float32, cuda) / N ** 0.5).to(
        torch.bfloat16)
    c = _randn(rng, (B, S, H, N), torch.bfloat16, cuda)
    before = ssd_mod.launches
    y, fin = ssd_mod.ssd_scan(x, log_a, b, c, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd_mod.launches == before + 1
    y_ref, fin_ref = ssd_ref(x.float(), log_a.float(), b.float(), c.float(),
                             chunk=chunk)
    _close(y, y_ref, SSD_TOL[torch.bfloat16])
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
    before = ssd_mod.launches
    y, fin = ssd_mod.ssd_scan(x, la, bc, bc, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd_mod.launches == before + 1
    y_ref, fin_ref = ssd_ref(x.float(), la.float(), bc.float(), bc.float(),
                             chunk=chunk)
    _close(y, y_ref, SSD_TOL[torch.bfloat16])
    _close(fin, fin_ref, SSD_TOL[torch.float32])


def test_ssd_scan_bf16_refuses_what_it_does_not_take(cuda):
    """The bf16 passes take chunk <= 256 with P <= 128 and N <= 64, or
    chunk <= 128 with P and N up to 384; they never hand another shape to
    the plain version or the fp32 kernel."""
    before = ssd_mod.launches
    for P, N, chunk in ((392, 16, 64), (64, 392, 64), (64, 16, 512),
                        (136, 16, 256), (384, 384, 256)):
        x = torch.zeros((1, 1024, 1, P), device=cuda, dtype=torch.bfloat16)
        b = torch.zeros((1, 1024, 1, N), device=cuda, dtype=torch.bfloat16)
        la = torch.zeros((1, 1024, 1), device=cuda)
        with pytest.raises(ValueError, match="bf16 kernel"):
            ssd_mod.ssd_scan(x, la, b, b, chunk=chunk)
    assert ssd_mod.launches == before


def test_ssd_scan_bf16_kernels_use_tensor_cores_without_spills(cuda):
    """Both tensor-core passes hold HMMA in every instance and spill
    nothing; the fp32 SIMT kernel holds no HMMA."""
    _build.build_all()
    ptxas = ssd_mod.mma_passes(_build.ptxas_report("ssd_scan"))
    counts = {f: c["HMMA"] for f, c in _build.sass_opcodes("ssd_scan").items()}
    hmma = ssd_mod.mma_passes(counts)
    assert sorted(hmma) == ["ssd_chunk_scan", "ssd_chunk_scan_wide",
                            "ssd_chunk_state"], counts
    assert all(n > 0 for ns in hmma.values() for n in ns), counts
    assert all(e["spill_stores"] == 0 for es in ptxas.values() for e in es), \
        ptxas
    simt = [n for f, n in counts.items() if "ssd_kernel" in f]
    assert simt and not any(simt), counts


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
    before, wide_before = ssd_mod.launches, ssd_mod.wide_launches
    y, fin = ssd_mod.ssd_scan(x, la, k, q, chunk=128)
    torch.cuda.synchronize()
    assert ssd_mod.launches == before + 1
    assert ssd_mod.wide_launches == wide_before + 1
    y_ref, fin_ref = ssd_ref(x.float(), la, k.float(), q.float(), chunk=128)
    _close(y, y_ref, SSD_TOL[torch.bfloat16])
    _close(fin, fin_ref, SSD_TOL[torch.float32])
    with pytest.raises(ValueError, match="fp32 kernel.*shared memory"):
        ssd_mod.ssd_scan(x.float(), la, k.float(), q.float(), chunk=128)
    assert ssd_mod.launches == before + 1


def test_ssd_scan_refuses_oversized_chunk(cuda):
    x = torch.zeros((1, 512, 2, 80), device=cuda)
    b = torch.zeros((1, 512, 2, 64), device=cuda)
    la = torch.zeros((1, 512, 2), device=cuda)
    before = ssd_mod.launches
    with pytest.raises(ValueError, match="shared memory"):
        ssd_mod.ssd_scan(x, la, b, b, chunk=256)
    assert ssd_mod.launches == before


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
])
def test_decode_attention_kernel_matches_plain(cuda, B, Smax, H, Hk, hd,
                                               softcap, dtype):
    q, k, v, lengths = _decode_inputs(4, B, Smax, H, Hk, hd, dtype, cuda)
    want = decode_attention_ref(q.float(), k.float(), v.float(), lengths,
                                softcap=softcap)
    block_ks = _fitting_block_ks(q, k, cuda)
    assert block_ks
    for bk in block_ks:
        before = da_mod.launches
        got = da_mod.decode_attention(q, k, v, lengths, softcap=softcap,
                                      block_k=bk)
        torch.cuda.synchronize()
        assert da_mod.launches == before + 1
        assert got.dtype == dtype and got.shape == q.shape
        _close(got, want, TOL[dtype])
        assert (got[lengths == 0] == 0).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_whisper_cross_cache(cuda, dtype):
    """whisper-medium's cross-attention in decode: every row reads the
    whole 1500-entry cross cache (16 heads of 64, width 8)."""
    q, k, v, _ = _decode_inputs(15, 8, 1500, 16, 16, 64, dtype, cuda)
    lengths = torch.full((8,), 1500, dtype=torch.int32, device=cuda)
    before = da_mod.launches
    got = da_mod.decode_attention(q, k, v, lengths)
    torch.cuda.synchronize()
    assert da_mod.launches == before + 1
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
        before = da_mod.launches
        got = da_mod.decode_attention(q, k, v, lengths, softcap=softcap,
                                      window=window, block_k=bk)
        assert da_mod.launches == before + 1
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
    before = da_mod.launches
    with pytest.raises(ValueError, match="shared memory"):
        da_mod.decode_attention(q, k, k, lengths, block_k=512)
    with pytest.raises(ValueError, match="one dtype"):
        da_mod.decode_attention(q, k.float(), k, lengths)
    assert da_mod.launches == before


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


def test_decode_attention_bf16_refuses_other_head_dims(cuda):
    q = torch.zeros((2, 4, 96), device=cuda, dtype=torch.bfloat16)
    k = torch.zeros((2, 64, 2, 96), device=cuda, dtype=torch.bfloat16)
    lengths = torch.full((2,), 64, dtype=torch.int32, device=cuda)
    before = da_mod.launches
    with pytest.raises(ValueError, match="head_dim"):
        da_mod.decode_attention(q, k, k, lengths)
    assert da_mod.launches == before


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
    before = (fa_mod.launches, ssd_mod.launches, da_mod.launches)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn(x)
        torch.cuda.synchronize()
    assert (fa_mod.launches, ssd_mod.launches, da_mod.launches) == before
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
    counts = (fa_mod.launches, ssd_mod.launches, da_mod.launches)
    graph, got = capture(fn, (x,), cuda)
    after = (fa_mod.launches, ssd_mod.launches, da_mod.launches)
    assert sum(after) - sum(counts) == (0 if kind == "zoo" else 1)
    graph.replay()
    graph.replay()
    torch.cuda.synchronize()
    assert (fa_mod.launches, ssd_mod.launches, da_mod.launches) == after
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


# -- the LM models and the serving engine on the card --------------------------
LM_SMALL = dict(d_model=64, n_heads=4, head_dim=16, d_ff=128, vocab=128,
                ssm_state=16, ssm_head_dim=16, ssm_chunk=16, window=16)


def _small_lm(arch, device):
    from repro_torch.models import build_model, get_config
    cfg = get_config(arch)
    n_layers = cfg.shared_attn_period * 2 if cfg.shared_attn_period \
        else len(cfg.pattern) * 2
    kv = 4 if cfg.n_kv_heads == cfg.n_heads else 2
    cfg = cfg.replace(n_layers=n_layers, n_kv_heads=kv,
                      query_pre_attn_scalar=16.0
                      if cfg.query_pre_attn_scalar else None,
                      **{k: v for k, v in LM_SMALL.items()
                         if k != "window" or cfg.window})
    return build_model(cfg, device=device)


# the kernels each small model's steps launch
LM_KERNELS = {"granite-8b": {"flash", "decode"}, "gemma2-9b": {"flash",
                                                               "decode"},
              "zamba2-2.7b": {"flash", "ssd", "decode"},
              "qwen2-moe-a2.7b": {"flash", "decode"}, "xlstm-125m": {"ssd"}}


@pytest.mark.parametrize("arch", ["granite-8b", "gemma2-9b", "zamba2-2.7b",
                                  "qwen2-moe-a2.7b", "xlstm-125m"])
def test_lm_steps_on_the_card_match_the_cpu(cuda, arch):
    """fp32: forward, prefill and ragged decode steps on the card (fp32
    kernels, TF32 off) against the CPU (the plain versions): forward at
    1e-3 absolute plus relative; past a cache by relative norm error at
    1e-3, since the bf16 caches can round a k (or a conv state) the two
    compute a float32 ulp apart to neighbouring bf16 values.  Every kernel
    of the model's path launches."""
    from repro_torch.models import layers as L
    cpu = _small_lm(arch, "cpu")
    card = _small_lm(arch, cuda)
    params = cpu.init(seed=0, dtype=torch.float32)
    dparams = L.tree_map(lambda a: a.to(cuda), params)
    rng = np.random.default_rng(12)
    tokens = torch.from_numpy(rng.integers(0, 128, (2, 32), dtype=np.int32))
    counts = (fa_mod.launches, ssd_mod.launches, da_mod.launches)
    tol = dict(rtol=1e-3, atol=1e-3)
    want, _ = cpu.forward(params, tokens)
    got, _ = card.forward(dparams, tokens.to(cuda))
    _close(got.cpu(), want, tol)
    caches = [m.init_cache(batch=2, max_len=48) for m in (cpu, card)]
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
        ("flash", "ssd", "decode"), counts,
        (fa_mod.launches, ssd_mod.launches, da_mod.launches))
        if after > before}
    assert launched == LM_KERNELS[arch]


@pytest.mark.parametrize("arch", ["gemma2-9b", "zamba2-2.7b",
                                  "qwen2-moe-a2.7b", "xlstm-125m"])
def test_engine_on_the_card_gives_the_cpu_tokens(cuda, arch):
    """fp32: the engine on the card yields the CPU engine's greedy tokens,
    on the bucketed path (gemma2, whose local layers' window of 16 the
    sequences outgrow; qwen2-moe) and the exact one (zamba2, xlstm)."""
    from repro_torch.models import layers as L
    from repro_torch.serving import Request, ServingEngine
    cpu = _small_lm(arch, "cpu")
    card = _small_lm(arch, cuda)
    params = cpu.init(seed=1, dtype=torch.float32)
    dparams = L.tree_map(lambda a: a.to(cuda), params)
    rng = np.random.default_rng(13)
    prompts = [rng.integers(0, 128, n) for n in (16, 8, 32, 16, 4)]
    tokens = []
    for model, p in ((cpu, params), (card, dparams)):
        eng = ServingEngine(model, p, width=2, max_len=64)
        for i, prompt in enumerate(prompts):
            eng.submit(Request(rid=i, prompt=prompt, max_new_tokens=12))
        eng.warmup()
        tokens.append([r.tokens for r in sorted(eng.run(),
                                                key=lambda r: r.rid)])
    assert tokens[0] == tokens[1]


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

    counts = (fa_mod.launches, da_mod.launches)
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
    assert fa_mod.launches > counts[0] and da_mod.launches > counts[1]


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
    before = ssd_mod.launches
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
    assert ssd_mod.launches == before + 2        # forward and prefill


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
    counts = (fa_mod.launches, da_mod.launches)
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
    assert fa_mod.launches > counts[0] and da_mod.launches > counts[1]
