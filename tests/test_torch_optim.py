"""The port's optimiser (``optim/{adamw,schedule,compress}.py``) against
the JAX package's, on the CPU.

``apply_updates`` runs three steps from one state on both, with clipping
and with 1-D leaves that take no decay: fp32 parameters within
``PARAM_TOL`` relative, bf16 ones within one bf16 ulp (``BF16_ULP``: a
last-bit difference in fp32 may round either way), moments within
``MOMENT_TOL`` of the leaf's largest magnitude (the global norm, and so
the clipping scale, sums in another order: an ulp there shows in the
moments' small entries, which are differences of larger terms).  The schedules agree at every step within ``SCHED_TOL``;
``quantize``/``dequantize`` agree bit for bit (both round half to even);
``compressed_psum`` over a 1-rank and a 2-rank gloo group equals JAX's
over an axis of size 1 and 2.
"""

import multiprocessing as mp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.optim import adamw as jadamw
from repro.optim import compress as jcompress
from repro.optim import schedule as jschedule

from repro_torch import convert
from repro_torch.models import layers as TL
from repro_torch.optim import (AdamWConfig, apply_updates, compressed_psum,
                               constant, cosine_with_warmup, dequantize,
                               init_state, quantize, tree_compressed_psum)

PARAM_TOL = 1e-6
BF16_ULP = 2.0 ** -7            # relative spacing of bf16 values
MOMENT_TOL = 1e-6
SCHED_TOL = 1e-6


def _tree(rng, dtype):
    return {"w": rng.standard_normal((8, 6)).astype(np.float32),
            "blocks": {"k": rng.standard_normal((3, 4, 5)).astype(np.float32),
                       "scale": rng.standard_normal(6).astype(np.float32)},
            "b": rng.standard_normal(5).astype(np.float32)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip", [None, 0.5])
def test_apply_updates_matches_jax(dtype, clip):
    rng = np.random.default_rng(0)
    p0 = _tree(rng, dtype)
    grads = [_tree(rng, dtype) for _ in range(3)]
    sched = jschedule.cosine_with_warmup(1e-2, 2, 3)
    jcfg = jadamw.AdamWConfig(lr=sched, weight_decay=0.1, clip_norm=clip)
    tcfg = AdamWConfig(lr=cosine_with_warmup(1e-2, 2, 3), weight_decay=0.1,
                       clip_norm=clip)
    jdt = getattr(jnp, dtype)
    jp = jax.tree.map(lambda a: jnp.asarray(a).astype(jdt), p0)
    js = jadamw.init_state(jp)
    tp = convert.to_torch(jax.tree.map(np.asarray, jp), "cpu")
    ts = convert.adamw_state_to_torch(jax.tree.map(np.asarray, js), "cpu")
    assert ts["step"].dtype == torch.int32 and \
        all(m.dtype == torch.float32 for m in TL.tree_leaves(ts["mu"]))
    for g in grads:
        jg = jax.tree.map(lambda a: jnp.asarray(a).astype(jdt), g)
        jp, js, jm = jadamw.apply_updates(jcfg, jp, jg, js)
        tg = convert.to_torch(jax.tree.map(np.asarray, jg), "cpu")
        same, ts, tm = apply_updates(tcfg, tp, tg, ts)
        assert same is tp                  # updated in place
        np.testing.assert_allclose(tm["grad_norm"].item(),
                                   float(jm["grad_norm"]), rtol=PARAM_TOL)
        np.testing.assert_allclose(tm["lr"].item(), float(jm["lr"]),
                                   rtol=SCHED_TOL)
    assert int(ts["step"]) == int(js["step"]) == 3
    for got, want in zip(TL.tree_leaves(tp), jax.tree.leaves(jp)):
        assert got.dtype == getattr(torch, dtype)
        rtol = PARAM_TOL if dtype == "float32" else BF16_ULP
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), rtol=rtol,
                                   atol=1e-7)
    for key in ("mu", "nu"):
        for got, want in zip(TL.tree_leaves(ts[key]),
                             jax.tree.leaves(js[key])):
            want = np.asarray(want)
            np.testing.assert_allclose(
                got.numpy(), want, rtol=MOMENT_TOL,
                atol=MOMENT_TOL * np.abs(want).max())


def test_no_decay_on_1d_leaves():
    params = {"w": torch.ones(2, 2), "b": torch.ones(2)}
    grads = {"w": torch.zeros(2, 2), "b": torch.zeros(2)}
    apply_updates(AdamWConfig(lr=0.1, weight_decay=0.5), params, grads,
                  init_state(params))
    assert torch.all(params["w"] < 1.0) and torch.all(params["b"] == 1.0)


def test_schedules_match_jax():
    jcos = jschedule.cosine_with_warmup(3e-3, 20, 100, final_frac=0.1)
    tcos = cosine_with_warmup(3e-3, 20, 100, final_frac=0.1)
    for step in range(0, 121):
        want = float(jcos(jnp.int32(step)))
        for arg in (step, torch.tensor(step, dtype=torch.int32)):
            got = tcos(arg)
            assert got.dtype == torch.float32 and got.ndim == 0
            np.testing.assert_allclose(got.item(), want, rtol=SCHED_TOL,
                                       atol=1e-12)
    assert constant(0.25)(7).item() == float(
        jschedule.constant(0.25)(jnp.int32(7))) == 0.25


def test_quantize_bit_for_bit():
    rng = np.random.default_rng(1)
    g = rng.standard_normal(257).astype(np.float32)
    g[:4] = [0.5, -0.5, 1.5, 2.5]          # ties round to even
    r = (1e-3 * rng.standard_normal(257)).astype(np.float32)
    for res in (None, r):
        jq, js, jr = jcompress.quantize(
            jnp.asarray(g), None if res is None else jnp.asarray(res))
        tq, tsc, tr = quantize(torch.from_numpy(g),
                               None if res is None else torch.from_numpy(res))
        assert tq.dtype == torch.int8
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        assert tsc.item() == float(js)
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
        np.testing.assert_array_equal(
            dequantize(tq, tsc).numpy(),
            np.asarray(jcompress.dequantize(jq, js)))


def _jax_psum(gs, rs):
    fn = jax.vmap(lambda g, r: jcompress.compressed_psum(g, "i", r),
                  axis_name="i")
    out, res = fn(jnp.asarray(gs), jnp.asarray(rs))
    return np.asarray(out), np.asarray(res)


def _inputs(n):
    rng = np.random.default_rng(2)
    gs = rng.standard_normal((n, 64)).astype(np.float32)
    rs = (1e-3 * rng.standard_normal((n, 64))).astype(np.float32)
    return gs, rs


def test_compressed_psum_one_rank_matches_jax(tmp_path):
    gs, rs = _inputs(1)
    want, want_res = _jax_psum(gs, rs)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        got, res = compressed_psum(torch.from_numpy(gs[0]),
                                   residual=torch.from_numpy(rs[0]))
        tree, tres = tree_compressed_psum(
            {"a": torch.from_numpy(gs[0]), "b": (torch.from_numpy(gs[0]),)})
    finally:
        dist.destroy_process_group()
    np.testing.assert_array_equal(got.numpy(), want[0])
    np.testing.assert_array_equal(res.numpy(), want_res[0])
    assert torch.equal(tree["a"], tree["b"][0])
    assert isinstance(tres["b"], tuple)


def _rank(rank, world, store, gs, rs, out):
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=world, rank=rank)
    try:
        got, res = compressed_psum(torch.from_numpy(gs[rank]),
                                   residual=torch.from_numpy(rs[rank]))
        out.put((rank, got.numpy(), res.numpy()))
    finally:
        dist.destroy_process_group()


def test_compressed_psum_two_ranks_match_jax(tmp_path):
    gs, rs = _inputs(2)
    want, want_res = _jax_psum(gs, rs)
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    procs = [ctx.Process(target=_rank, args=(r, 2, tmp_path / "store", gs,
                                             rs, out)) for r in range(2)]
    for p in procs:
        p.start()
    results = {}
    for _ in range(2):
        rank, got, res = out.get(timeout=120)
        results[rank] = (got, res)
    for p in procs:
        p.join(timeout=60)
        assert not p.is_alive() and p.exitcode == 0
    for rank in range(2):
        np.testing.assert_array_equal(results[rank][0], want[rank])
        np.testing.assert_array_equal(results[rank][1], want_res[rank])
