"""The port's CUDA kernels against their plain PyTorch versions, on the card.

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

from repro_torch.kernels import _build
from repro_torch.kernels import decode_attention as da_mod
from repro_torch.kernels import flash_attention as fa_mod
from repro_torch.kernels import ssd_scan as ssd_mod
from repro_torch.kernels.ref import (decode_attention_ref,
                                     flash_attention_ref, ssd_ref)
from repro_torch.kernels.substrate import card_smem_limit

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
    """The bf16 passes take chunk <= 256, P <= 128 and N <= 64; they never
    hand another shape to the plain version or the fp32 kernel."""
    before = ssd_mod.launches
    for P, N, chunk in ((136, 16, 64), (64, 72, 64), (64, 16, 512)):
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
    assert sorted(hmma) == ["ssd_chunk_scan", "ssd_chunk_state"], counts
    assert all(n > 0 for ns in hmma.values() for n in ns), counts
    assert all(e["spill_stores"] == 0 for es in ptxas.values() for e in es), \
        ptxas
    simt = [n for f, n in counts.items() if "ssd_kernel" in f]
    assert simt and not any(simt), counts


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
