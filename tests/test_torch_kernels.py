"""The port's kernel modules against the JAX package's kernels, on the CPU.

Inputs are made from a seed with numpy and fed to both: the JAX Pallas
kernels run as tests/test_kernels.py runs them (``interpret=True``) and the
JAX oracles in ``repro.kernels.ref``; the port's wrappers take their plain
PyTorch versions for CPU tensors.  Tolerances: fp32 2e-5 and bf16 3e-2
(tests/test_kernels.py:18-19), except the fp32 SSD scan, which keeps the
tolerances the JAX package's own tests give it (2e-4 for y, 1e-3 for the
final state, tests/test_kernels.py:138-143): its outputs reach ~80 and the
two implementations sum each chunk's terms in another order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.kernels.ssd_scan import ssd_scan as jax_ssd
from repro_torch.core.graph import TensorSpec
from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as fa_mod
from repro_torch.kernels import ssd_scan as ssd_mod
from repro_torch.kernels.ops import (flash_attention, flash_attention_node,
                                     smem_footprint, ssd_scan, ssd_scan_node)
from repro_torch.kernels.substrate import (DEFAULT_CANDIDATES,
                                           KernelAutotuner, pad_axis_to,
                                           round_up)

TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=3e-2, atol=3e-2)}
SSD_Y_TOL = {"float32": dict(rtol=2e-4, atol=2e-4),
             "bfloat16": dict(rtol=3e-2, atol=3e-2)}
SSD_FIN_TOL = dict(rtol=1e-3, atol=1e-3)
H100_SMEM = 232448          # shared memory a block may opt in to on an H100


def _both(a, dtype):
    """One numpy array as a JAX array and a CPU tensor of ``dtype``."""
    j = jnp.asarray(a).astype(getattr(jnp, dtype))
    t = torch.from_numpy(a).to(getattr(torch, dtype))
    return j, t


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


def _qkv(seed, B, Sq, Sk, H, Hk, hd, dtype):
    rng = np.random.default_rng(seed)
    shapes = [(B, Sq, H, hd), (B, Sk, Hk, hd), (B, Sk, Hk, hd)]
    arrs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    pairs = [_both(a, dtype) for a in arrs]
    return [p[0] for p in pairs], [p[1] for p in pairs]


@pytest.mark.parametrize("B,Sq,Sk,H,Hk,hd,dtype,opts", [
    (1, 256, 256, 4, 4, 64, "float32", {}),                       # MHA
    (1, 256, 256, 4, 4, 64, "bfloat16", {}),
    (2, 256, 256, 8, 2, 64, "float32", {}),                       # GQA 4:1
    (2, 256, 256, 8, 2, 64, "bfloat16", {}),
    (1, 512, 512, 4, 1, 128, "float32", {}),                      # MQA
    (1, 128, 128, 2, 2, 256, "float32", {}),                      # hd 256
    (1, 512, 512, 4, 2, 64, "float32", {"window": 64}),
    (1, 512, 512, 4, 2, 64, "float32", {"window": 200}),
    (1, 256, 256, 4, 2, 64, "float32", {"softcap": 50.0}),
    (1, 256, 256, 4, 4, 64, "float32", {"causal": False}),
    (1, 200, 200, 4, 2, 64, "float32", {}),                       # uneven
    (1, 384, 200, 4, 2, 64, "float32", {}),
    (1, 130, 257, 4, 2, 64, "float32", {}),
    (1, 200, 200, 4, 2, 64, "float32", {"causal": False}),
    (1, 384, 200, 4, 2, 64, "float32", {"causal": False}),
    (1, 130, 257, 4, 2, 64, "float32", {"causal": False}),
    (1, 300, 300, 4, 2, 64, "float32", {"window": 70, "softcap": 30.0}),
])
def test_flash_attention_matches_jax(B, Sq, Sk, H, Hk, hd, dtype, opts):
    (jq, jk, jv), (tq, tk, tv) = _qkv(0, B, Sq, Sk, H, Hk, hd, dtype)
    kw = dict(dict(causal=True), **opts)
    got = flash_attention(tq, tk, tv, block_q=128, block_k=128, **kw)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    _close(got, jax_flash(jq, jk, jv, block_q=128, block_k=128,
                          interpret=True, **kw), TOL[dtype])
    _close(got, jref.flash_attention_ref(jq, jk, jv, **kw), TOL[dtype])


def test_flash_attention_fully_masked_rows_give_zeros():
    """Rows whose window lies wholly past Sk: the port returns zeros (the
    kernel's ``l == 0`` case), where the JAX oracle's softmax gives NaN."""
    (jq, jk, jv), (tq, tk, tv) = _qkv(1, 1, 384, 200, 2, 2, 64, "float32")
    got = flash_attention(tq, tk, tv, causal=True, window=64)
    want = np.asarray(jref.flash_attention_ref(jq, jk, jv, causal=True,
                                               window=64))
    masked = np.isnan(want).all(axis=(0, 2, 3))
    assert masked[263:].all() and not masked[:263].any()
    assert (got[:, 263:] == 0).all()
    _close(got, np.nan_to_num(want), TOL["float32"])
    # the Pallas kernel agrees on every row that has an unmasked key (its
    # finite -1e30 mask averages the masked values on the others)
    kern = jax_flash(jq, jk, jv, causal=True, window=64, interpret=True)
    _close(got[:, :263], np.asarray(kern)[:, :263], TOL["float32"])


def _ssd_inputs(seed, B, S, H, P, N, dtype):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    la = -np.logaddexp(0.0, rng.standard_normal((B, S, H))).astype(np.float32)
    b = rng.standard_normal((B, S, H, N)).astype(np.float32)
    c = rng.standard_normal((B, S, H, N)).astype(np.float32)
    pairs = [_both(x, dtype), _both(la, "float32"), _both(b, dtype),
             _both(c, dtype)]
    return [p[0] for p in pairs], [p[1] for p in pairs]


@pytest.mark.parametrize("B,S,H,P,N,chunk,dtype", [
    (1, 256, 2, 64, 64, 64, "float32"),
    (1, 256, 2, 64, 64, 64, "bfloat16"),
    (2, 256, 4, 64, 32, 128, "float32"),
    (1, 512, 1, 128, 64, 128, "float32"),
    (1, 512, 1, 128, 64, 128, "bfloat16"),
    (1, 200, 2, 32, 16, 128, "float32"),                         # uneven
    (1, 257, 2, 32, 16, 128, "float32"),
    (1, 130, 2, 32, 16, 64, "float32"),
])
def test_ssd_scan_matches_jax(B, S, H, P, N, chunk, dtype):
    jargs, targs = _ssd_inputs(2, B, S, H, P, N, dtype)
    y, fin = ssd_scan(*targs, chunk=chunk)
    assert y.dtype == targs[0].dtype and fin.dtype == torch.float32
    assert fin.shape == (B, H, N, P)
    jy, jfin = jax_ssd(*jargs, chunk=chunk, interpret=True)
    ry, rfin = jref.ssd_ref(*jargs)
    for want_y, want_fin in ((jy, jfin), (ry, rfin)):
        _close(y, want_y, SSD_Y_TOL[dtype])
        _close(fin, want_fin, SSD_FIN_TOL)


def test_ssd_scan_no_nan_from_large_decay():
    """A strongly decaying chunk: exp(seg_i - seg_j) above the diagonal
    would overflow; it must never be formed."""
    jargs, targs = _ssd_inputs(3, 1, 128, 2, 16, 8, "float32")
    la = torch.full((1, 128, 2), -20.0)
    y, fin = ssd_scan(targs[0], la, targs[2], targs[3], chunk=128)
    assert torch.isfinite(y).all() and torch.isfinite(fin).all()
    jy, _ = jax_ssd(jargs[0], jnp.asarray(la.numpy()), jargs[2], jargs[3],
                    chunk=128, interpret=True)
    _close(y, jy, SSD_Y_TOL["float32"])


def test_wrappers_on_cpu_leave_launch_counters():
    fa_mod.launches = ssd_mod.launches = 0
    x = torch.randn(1, 64, 2, 16)
    flash_attention(x, x, x)
    ssd_scan(x, x.mean(dim=-1), x[..., :8], x[..., :8], chunk=32)
    assert fa_mod.launches == 0 and ssd_mod.launches == 0


def test_wrappers_trace_on_meta():
    x = torch.empty(1, 4096, 32, 80, dtype=torch.bfloat16, device="meta")
    o = flash_attention(x, x, x, block_q=64, block_k=64)
    assert o.device.type == "meta" and o.shape == x.shape
    assert o.dtype == torch.bfloat16
    y, fin = ssd_scan(x, x.mean(dim=-1), x[..., :64], x[..., :64], chunk=32)
    assert y.shape == x.shape and fin.shape == (1, 32, 64, 80)


@pytest.mark.parametrize("kernel,params,dtype,hd,want", [
    # zamba2-2.7b widths: (1, 4096, 32, 80) activation, SSM state 64
    ("flash_attention", {"block_q": 64, "block_k": 64}, "float32", 80, 99328),
    ("flash_attention", {"block_q": 128, "block_k": 128}, "float32", 80,
     231424),
    ("flash_attention", {"block_q": 256, "block_k": 64}, "float32", 80,
     273664),
    ("ssd_scan", {"chunk": 128}, "float32", 80, 195072),
    ("ssd_scan", {"chunk": 256}, "float32", 80, 500736),
    # bf16 SSD: the larger of the chunk-state and chunk-scan passes (the
    # scan's c, b, x and S_in high/low parts, rows padded to 16k + 8)
    ("ssd_scan", {"chunk": 32}, "bfloat16", 80, 37632),
    ("ssd_scan", {"chunk": 64}, "bfloat16", 80, 52736),
    ("ssd_scan", {"chunk": 256}, "bfloat16", 80, 143360),
    # bf16 route: q tile + two stages of k and v, rows padded to hd + 8
    ("flash_attention", {"block_q": 64, "block_k": 64}, "bfloat16", 80,
     56320),
    ("flash_attention", {"block_q": 128, "block_k": 128}, "bfloat16", 80,
     112640),
    ("flash_attention", {"block_q": 256, "block_k": 256}, "bfloat16", 80,
     225280),
    ("flash_attention", {"block_q": 256, "block_k": 256}, "bfloat16", 256,
     675840),
])
def test_smem_footprint(kernel, params, dtype, hd, want):
    x = torch.empty(1, 4096, 32, hd, dtype=getattr(torch, dtype),
                    device="meta")
    assert smem_footprint(kernel, params, (x,), {"state_dim": 64}) == want


@pytest.mark.parametrize("shape,N,chunk,dtype,L,want", [
    # zamba2-2.7b widths: (B, H, nc, N, P) fp32 states and (B, H, nc) decays
    ((1, 4096, 32, 80), 64, 32, torch.bfloat16, 32, 4 * 32 * 128 * 5121),
    ((1, 4096, 32, 80), 64, 64, torch.bfloat16, 64, 4 * 32 * 64 * 5121),
    ((1, 4096, 32, 80), 64, 256, torch.bfloat16, 256, 4 * 32 * 16 * 5121),
    ((2, 200, 3, 40), 24, 64, torch.bfloat16, 64, 4 * 2 * 3 * 4 * 961),
    ((1, 1, 2, 32), 16, 128, torch.bfloat16, 16, 4 * 2 * 1 * 513),  # S = 1
    ((1, 4096, 32, 80), 64, 64, torch.float32, 64, 0),   # fp32: no passes
])
def test_ssd_workspace_bytes(shape, N, chunk, dtype, L, want):
    """The bf16 route's chunk is min(chunk, S) rounded up to 16, and its
    workspace holds one fp32 state and one decay per chunk."""
    shapes = (shape, (*shape[:3], N))
    assert ssd_mod.chunk_length(chunk, shape[1], dtype) == L
    assert ssd_mod.workspace_bytes({"chunk": chunk}, shapes, dtype) == want


def test_flash_tile_sizes_round_up_for_bf16():
    """The bf16 route rounds block_q up to whole warps of up to 32 rows and
    block_k up to whole 64-key steps; fp32 cuts each to its sequence."""
    assert fa_mod.tile_sizes(128, 128, 130, 200, torch.bfloat16) == (128, 128)
    assert fa_mod.tile_sizes(256, 256, 130, 200, torch.bfloat16) == (160, 256)
    assert fa_mod.tile_sizes(64, 64, 8, 8, torch.bfloat16) == (32, 64)
    assert fa_mod.tile_sizes(256, 256, 130, 200, torch.float32) == (130, 200)
    assert fa_mod.smem_bytes({"block_q": 256, "block_k": 256},
                             ((1, 130, 4, 64), (1, 200, 4, 64)),
                             torch.bfloat16) == 2 * 72 * (160 + 4 * 256)


# excerpts of nvcc's -Xptxas -v report and of cuobjdump -sass for two
# instances of csrc/flash_attention.cu
MMA80 = ("_ZN11repro_torch12_GLOBAL__N_113fa_mma_kernelILi80ELi2ELi8EEEvPK13"
         "__nv_bfloat16S4_S4_PS2_iiiiNS0_7StridesES5_S5_S5_iiiifff")
SIMT = "_ZN11repro_torch12_GLOBAL__N_19fa_kernelIfEEvPKT_S4_S4_PS2_iiiii"
PTXAS_LOG = f"""\
ptxas info    : Compiling entry function '{MMA80}' for 'sm_90a'
ptxas info    : Function properties for {MMA80}
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 252 registers, used 0 barriers, 416 bytes cmem[0]
ptxas info    : Compiling entry function '{SIMT}' for 'sm_90a'
ptxas info    : Function properties for {SIMT}
    32 bytes stack frame, 28 bytes spill stores, 28 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 420 bytes cmem[0]
"""
SASS = f"""\
\t\tFunction : {MMA80}
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   HMMA.16816.F32.BF16 R8, R4, R2, R8 ;
        /*0020*/              @!P0 HMMA.16816.F32.BF16 R12, R4, R2, R12 ;
        /*0030*/               @P1 BRA `(.L_x_1) ;
\t\tFunction : {SIMT}
        /*0000*/                   FFMA R3, R4, R5, R3 ;
        /*0010*/                   EXIT ;
"""


def test_build_reports_parse_per_kernel():
    """ptxas registers and spills, and SASS opcode counts, per kernel; the
    bf16 instances grouped by their head_dim."""
    report = _build.parse_ptxas(PTXAS_LOG)
    assert report == {
        MMA80: {"spill_stores": 0, "spill_loads": 0, "registers": 252},
        SIMT: {"spill_stores": 28, "spill_loads": 28, "registers": 128}}
    ops = _build.parse_sass(SASS)
    assert ops[MMA80] == {"LDC": 1, "HMMA": 2, "BRA": 1}
    assert ops[SIMT] == {"FFMA": 1, "EXIT": 1}
    assert fa_mod.mma_instances(report) == {80: [report[MMA80]]}
    assert fa_mod.mma_instances({SIMT: 1}) == {}


def test_ssd_mma_passes_pick_the_launched_instance():
    """The bf16 passes are instances per log_a dtype and P's n8 tiles (P
    rounded up to 16, then 4, 8, 10 or 16 tiles); a report reduces to the
    instances a launch at width P runs."""
    ns = "_ZN11repro_torch12_GLOBAL__N_1"
    report = {f"{ns}14ssd_chunk_scanI13__nv_bfloat16Li10EEEvNS_9ChunkArgsE": 1,
              f"{ns}15ssd_chunk_stateI13__nv_bfloat16Li10EEEvNS_9ChunkArgsE": 2,
              f"{ns}14ssd_chunk_scanIfLi10EEEvNS_9ChunkArgsE": 3,
              f"{ns}15ssd_chunk_stateIfLi16EEEvNS_9ChunkArgsE": 4,
              f"{ns}10ssd_kernelIffEEvPKT_PKT0_S4_S4_PS2_Pfiiii": 5}
    assert [ssd_mod.mma_tiles(P) for P in (16, 32, 40, 64, 80, 128)] == \
        [4, 4, 8, 8, 10, 16]
    assert ssd_mod.mma_passes(report) == {"ssd_chunk_scan": [1, 3],
                                          "ssd_chunk_state": [2, 4]}
    assert ssd_mod.mma_passes(report, 80, torch.bfloat16) == {
        "ssd_chunk_scan": [1], "ssd_chunk_state": [2]}
    assert ssd_mod.mma_passes(report, 128, torch.float32) == {
        "ssd_chunk_state": [4]}


def test_autotuner_prunes_over_the_shared_memory_limit():
    """Candidates over the per-block limit go to ``pruned`` with their byte
    count and are never measured."""
    measured = []

    def measure(fn, args):
        measured.append(fn)
        return float(len(measured))

    tuner = KernelAutotuner(measure=measure, smem_limit=H100_SMEM,
                            device="cpu")
    x = torch.zeros(1, 512, 4, 80)
    rec = tuner.tune("flash_attention", lambda p: p, (x,), options={})
    kept = [p for p in DEFAULT_CANDIDATES["flash_attention"]
            if 256 not in p.values()]
    assert len(rec.trials) == len(kept) == len(measured) == 4
    assert len(rec.pruned) == 5 and rec.vmem_limit == H100_SMEM
    assert all(v > H100_SMEM for v in rec.pruned.values())
    assert rec.params == {"block_q": 64, "block_k": 64}     # measured first

    # the fp32 SSD kernel keeps its chunk in shared memory: 256 is pruned;
    # the bf16 passes fit every candidate
    spec = TensorSpec((1, 512, 4, 80), torch.float32)
    node = ssd_scan_node("ssd", state_dim=64, device="cpu")
    rec = tuner.tune_node(node, resource="cloud", in_specs=[spec])
    assert set(rec.pruned) == {'{"chunk": 256}'}
    assert node.kernel_params == rec.params
    spec = TensorSpec((1, 512, 4, 80), torch.bfloat16)
    rec = tuner.tune_node(ssd_scan_node("ssd", state_dim=64, device="cpu"),
                          resource="cloud", in_specs=[spec])
    assert not rec.pruned and len(rec.trials) == 4
    with pytest.raises(RuntimeError, match="shared-memory limit"):
        KernelAutotuner(measure=measure, smem_limit=1024,
                        device="cpu").tune_node(
            flash_attention_node("a", device="cpu"), in_specs=[spec])


def test_autotuner_prunes_bf16_flash_by_its_own_footprint():
    """In bf16 every candidate fits at head_dim 80, so the tuner picks
    among all nine; at head_dim 256, 256/256 (675,840 B) is pruned."""
    measured = []

    def measure(fn, args):
        measured.append(fn)
        return float(len(measured))

    tuner = KernelAutotuner(measure=measure, smem_limit=H100_SMEM,
                            device="cpu")
    cands = DEFAULT_CANDIDATES["flash_attention"]
    x = torch.zeros(1, 512, 4, 80, dtype=torch.bfloat16)
    rec = tuner.tune("flash_attention", lambda p: p, (x,), options={})
    assert not rec.pruned and len(rec.trials) == len(measured) == len(cands)

    x = torch.zeros(1, 512, 2, 256, dtype=torch.bfloat16)
    rec = tuner.tune("flash_attention", lambda p: p, (x,), options={})
    assert rec.pruned['{"block_k": 256, "block_q": 256}'] == 675840
    assert all(v > H100_SMEM for v in rec.pruned.values())
    assert len(rec.trials) + len(rec.pruned) == len(cands)


def test_pad_helpers():
    assert round_up(130, 128) == 256 and round_up(128, 128) == 128
    with pytest.raises(ValueError):
        round_up(5, 0)
    x = torch.ones(2, 5, 3)
    y = pad_axis_to(x, 1, 8)
    assert y.shape == (2, 8, 3) and (y[:, 5:] == 0).all()
    assert pad_axis_to(x, 1, 5) is x
    np.testing.assert_array_equal(
        pad_axis_to(x, -1, 4).numpy(),
        np.asarray(jnp.pad(jnp.ones((2, 5, 3)), ((0, 0), (0, 0), (0, 1)))))
    with pytest.raises(ValueError):
        pad_axis_to(x, 1, 4)
