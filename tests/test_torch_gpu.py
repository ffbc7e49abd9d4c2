"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: every test takes the ``cuda`` fixture, which skips where
``torch.cuda.is_available()`` is false (decided at run time, never at
import).  The file imports no JAX, so it runs on a GPU host that has none:

    PYTHONPATH=src python -m pytest tests/test_torch_gpu.py -m gpu

Inputs come from numpy with a seed.  Tolerances: fp32 2e-5 for attention
and 2e-4 for the SSD scan (its outputs sum hundreds of terms of magnitude
~10), bf16 3e-2, as in tests/test_kernels.py; the plain versions run in
fp32 with TF32 off.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa_mod
from repro_torch.kernels import ssd_scan as ssd_mod
from repro_torch.kernels.ref import flash_attention_ref, ssd_ref

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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Sq,Sk,H,Hk,hd,causal,window,softcap,bq,bk", [
    (1, 256, 256, 4, 4, 64, True, None, None, 128, 128),      # MHA
    (2, 256, 256, 8, 2, 64, True, None, None, 128, 128),      # GQA 4:1
    (1, 128, 128, 2, 2, 256, True, None, None, 32, 32),       # head_dim 256
    (1, 512, 512, 4, 2, 64, True, 200, None, 128, 64),        # window
    (1, 300, 300, 4, 2, 64, True, 70, 30.0, 128, 128),        # window+softcap
    (1, 200, 200, 4, 2, 64, False, None, None, 128, 128),     # uneven
    (1, 384, 200, 4, 2, 64, True, None, None, 128, 128),
    (1, 130, 257, 4, 2, 64, True, None, None, 64, 128),
    (1, 640, 640, 32, 32, 80, True, None, None, 128, 128),    # zamba2 heads
])
def test_flash_attention_kernel_matches_plain(cuda, B, Sq, Sk, H, Hk, hd,
                                              causal, window, softcap, bq,
                                              bk, dtype):
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


def test_flash_attention_fully_masked_rows_are_zero(cuda):
    """Rows whose window lies wholly past Sk have no unmasked key."""
    rng = np.random.default_rng(1)
    q = _randn(rng, (1, 384, 2, 64), torch.float32, cuda)
    k = _randn(rng, (1, 200, 2, 64), torch.float32, cuda)
    got = fa_mod.flash_attention(q, k, k, causal=True, window=64)
    want = flash_attention_ref(q, k, k, causal=True, window=64)
    assert torch.isfinite(got).all()
    assert (got[:, 263:] == 0).all()
    _close(got, want, TOL[torch.float32])


def test_flash_attention_refuses_oversized_tiles(cuda):
    x = torch.zeros((1, 512, 2, 80), device=cuda, dtype=torch.bfloat16)
    before = fa_mod.launches
    with pytest.raises(ValueError, match="shared memory"):
        fa_mod.flash_attention(x, x, x, block_q=256, block_k=256)
    assert fa_mod.launches == before


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


def test_ssd_scan_refuses_oversized_chunk(cuda):
    x = torch.zeros((1, 512, 2, 80), device=cuda)
    b = torch.zeros((1, 512, 2, 64), device=cuda)
    la = torch.zeros((1, 512, 2), device=cuda)
    before = ssd_mod.launches
    with pytest.raises(ValueError, match="shared memory"):
        ssd_mod.ssd_scan(x, la, b, b, chunk=256)
    assert ssd_mod.launches == before
