"""The port's xLSTM blocks (``repro_torch.models.xlstm``) against the JAX
package's, on the CPU, in fp32.

A reduced xlstm-125m (d_model 64, 4 heads: the mLSTM's heads are 32 wide,
chunk 8) with the JAX package's parameter draws plus seeded numpy noise on
its constant leaves, carried by ``convert.to_torch``; inputs are seeded
numpy normals.  The blocks are held at 1e-4 absolute plus relative
(test_torch_lm.py's fp32 tolerance) in each mode: forward (no state),
prefill (from a zero state) and a decode step from the prefill's state.
The sLSTM's stabiliser starts at -1e9 without a state and at 0 from a
zeroed one, so forward and prefill differ in both packages by the same
amount; the whole model shows it too.  The SSD scan at the full model's
mLSTM widths (4 heads of 384) is held against the JAX package's sequential
``ssd_ref`` at the fp32 tolerance of tests/test_kernels.py:18-19 (2e-5),
with the mLSTM's scaling of b (k / sqrt(384)).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.models import build_model as jax_build
from repro.models import get_config as jax_config
from repro.models import layers as JL
from repro.models import xlstm as jx

from repro_torch.convert import to_torch
from repro_torch.kernels import ref
from repro_torch.models import build_model, get_config
from repro_torch.models import layers as TL
from repro_torch.models import xlstm as tx

from test_torch_lm import jax_params, reduce_cfg

TOL = dict(rtol=1e-4, atol=1e-4)
B, S = 2, 16


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


@pytest.fixture(scope="module")
def xlstm():
    """(reduced cfg, JAX params, port params) of a reduced xlstm-125m."""
    jcfg = reduce_cfg(jax_config("xlstm-125m"))
    np_params = jax_params(jax_build(jcfg), "float32")
    return (jcfg, jax.tree.map(jnp.asarray, np_params),
            to_torch(np_params, "cpu"))


def _blocks(jp, tp, kind):
    """The first ``kind`` sub-layer's core parameters of both trees."""
    name = "s0_mlstm" if kind == "mlstm" else "s1_slstm"
    return (jax.tree.map(lambda a: a[0], jp["layers"][name]["core"]),
            TL.tree_map(lambda a: a[0], tp["layers"][name]["core"]))


def _x(cfg, seq=S, seed=1):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((B, seq, cfg.d_model)).astype(np.float32)


def test_mlstm_forward_prefill_decode_match_jax(xlstm):
    cfg, jp, tp = xlstm
    jb, tb = _blocks(jp, tp, "mlstm")
    x, x1 = _x(cfg), _x(cfg, seq=1, seed=2)
    jy, (jmat, jconv) = jx.mlstm(jb, cfg, jnp.asarray(x))
    ty, (tmat, tconv) = tx.mlstm(tb, cfg, torch.from_numpy(x))
    _close(ty, jy)
    _close(tmat, jmat)
    _close(tconv, jconv)
    # prefill from a zero state, then one decode step from its state
    d_inner, H, hd = tx.mlstm_dims(cfg)
    zeros = np.zeros((B, H, hd, hd), np.float32)
    jy0, (jmat0, jconv0) = jx.mlstm(jb, cfg, jnp.asarray(x),
                                    state=jnp.asarray(zeros))
    ty0, (tmat0, tconv0) = tx.mlstm(tb, cfg, torch.from_numpy(x),
                                    state=torch.from_numpy(zeros))
    _close(ty0, jy0)
    _close(tmat0, jmat0)
    jy1, (jmat1, _) = jx.mlstm(jb, cfg, jnp.asarray(x1), state=jmat0,
                               conv_state=jconv0, decode=True)
    ty1, (tmat1, _) = tx.mlstm(tb, cfg, torch.from_numpy(x1), state=tmat0,
                               conv_state=tconv0, decode=True)
    _close(ty1, jy1)
    _close(tmat1, jmat1)


def test_slstm_stabiliser_start_and_decode_match_jax(xlstm):
    """No state (forward: m from -1e9), a zero state (prefill: m from 0)
    and a decode step: each equals the reference, and the first two differ
    from each other as the reference's do."""
    cfg, jp, tp = xlstm
    jb, tb = _blocks(jp, tp, "slstm")
    x, x1 = _x(cfg, seed=3), _x(cfg, seq=1, seed=4)
    H, hd = cfg.n_heads, cfg.d_model // cfg.n_heads
    zero = np.zeros((B, H, hd), np.float32)
    jfwd, jst_f = jx.slstm(jb, cfg, jnp.asarray(x))
    tfwd, tst_f = tx.slstm(tb, cfg, torch.from_numpy(x))
    jpre, jst = jx.slstm(jb, cfg, jnp.asarray(x),
                         state=tuple(jnp.asarray(zero) for _ in range(4)))
    tpre, tst = tx.slstm(tb, cfg, torch.from_numpy(x),
                         state=tuple(torch.from_numpy(zero) for _ in range(4)))
    _close(tfwd, jfwd)
    _close(tpre, jpre)
    for got, want in zip(tst_f + tst, jst_f + jst):
        _close(got, want)
    # the stabiliser's start moves the output, in both packages alike
    jdiff = np.asarray(jfwd) - np.asarray(jpre)
    assert np.abs(jdiff).max() > 1e-3
    _close(tfwd - tpre, jdiff)
    jy1, jst1 = jx.slstm(jb, cfg, jnp.asarray(x1), state=jst, decode=True)
    ty1, tst1 = tx.slstm(tb, cfg, torch.from_numpy(x1), state=tst,
                         decode=True)
    _close(ty1, jy1)
    for got, want in zip(tst1, jst1):
        _close(got, want)


def test_model_forward_and_prefill_differ_as_in_jax(xlstm):
    """The whole reduced model: the last position's logits from
    ``forward`` and from ``prefill`` differ (the sLSTM's stabiliser), by
    what the reference's differ."""
    cfg, jp, tp = xlstm
    jmodel = jax_build(cfg)
    tmodel = build_model(reduce_cfg(get_config("xlstm-125m")), device="cpu")
    tokens = np.random.default_rng(5).integers(0, cfg.vocab, (B, S),
                                               dtype=np.int32)
    jh, _ = jmodel.forward(jp, jnp.asarray(tokens))
    jfwd = JL.unembed(jp["embed"], jh[:, -1:])
    jpre, _ = jmodel.prefill(jp, jnp.asarray(tokens),
                             jmodel.init_cache(batch=B, max_len=32))
    th, _ = tmodel.forward(tp, torch.from_numpy(tokens))
    tfwd = TL.unembed(tp["embed"], th[:, -1:])
    tpre, _ = tmodel.prefill(tp, torch.from_numpy(tokens),
                             tmodel.init_cache(batch=B, max_len=32))
    jdiff = np.asarray(jfwd) - np.asarray(jpre)
    assert np.abs(jdiff).max() > 1e-3
    _close(tfwd - tpre, jdiff, dict(rtol=1e-3, atol=1e-3))


def test_cache_leaves_in_the_reference_order(xlstm):
    """The sLSTM cache's (c, n, h, m) tuple: leaves in the reference's
    pytree order (sorted keys, then positions), as the engine walks them."""
    cfg, _, _ = xlstm
    jcache = jax_build(cfg).init_cache(batch=B, max_len=32)
    tcache = build_model(reduce_cfg(get_config("xlstm-125m")),
                         device="cpu").init_cache(batch=B, max_len=32)
    want = [(tuple(a.shape), str(a.dtype)) for a in jax.tree.leaves(jcache)]
    got = [(tuple(t.shape), str(t.dtype).replace("torch.", ""))
           for t in TL.tree_leaves(tcache)]
    assert got == want
    assert isinstance(tcache["s1_slstm"]["s"], tuple)
    assert len(tcache["s1_slstm"]["s"]) == 4


def test_ssd_ref_at_mlstm_widths_matches_jax():
    rng = np.random.default_rng(3)
    Bn, Sn, H, P = 1, 512, 2, 384
    x = (rng.standard_normal((Bn, Sn, H, P)) * 0.5).astype(np.float32)
    la = -np.logaddexp(0.0, rng.standard_normal((Bn, Sn, H))).astype(
        np.float32)
    b = (rng.standard_normal((Bn, Sn, H, P)) / np.sqrt(P)).astype(np.float32)
    c = rng.standard_normal((Bn, Sn, H, P)).astype(np.float32)
    jy, jfin = jref.ssd_ref(*map(jnp.asarray, (x, la, b, c)))
    ty, tfin = ref.ssd_ref(*map(torch.from_numpy, (x, la, b, c)), chunk=128)
    _close(ty, jy, dict(rtol=2e-5, atol=2e-5))
    _close(tfin, jfin, dict(rtol=2e-5, atol=2e-5))
