"""Decode over a KV cache split on its sequence, on the CPU.

The plain version's per-row key bounds (``starts``) and log-sum-exp
(``return_lse``) against the whole cache; ``combine_partials`` over R
slices against the unsplit call, at the reference's tolerances
(``tests/test_kernels.py:18-19``: fp32 2e-5, bf16 3e-2); then the split-KV
combine across ranks (``kernels/sharded.py``) in spawned gloo groups: a
1 x 4 ``data x model`` mesh whose cache is split 4 ways on its sequence
(``act_kv_seq``) and a 2 x 2 mesh over both dimensions
(``act_kv_seq_full``), each with a reduced granite-8b and a reduced
gemma2-9b (window 8 over a 48-entry cache).  On each rank: the attention
on fp32 DTensors split as the cache is, against the plain version over the
whole cache within ``SHARD_TOL``; a sharded prefill, held against the
unsharded one at the cache tolerance of tests/test_torch_lm.py (the
sharded projections sum in another order, and a k or v a float32 ulp apart
can round to a neighbouring bf16 value in the cache: ~2e-4 on gemma2-9b's
logits); then four greedy decode steps from that prefill's cache, sharded
and unsharded: tokens equal, logits within ``SHARD_TOL``.  On the 1 x 4
mesh with the JAX model's weights, the sharded steps are also held against
the JAX model's ``decode_step`` from the same cache at the cache
tolerance.  Only those tests import JAX (``-k "not jax"`` runs the rest on
a host without it); the spawned ranks import this module without it.
"""

import multiprocessing as mp
import queue

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.kernels import decode_attention as da_mod
from repro_torch.kernels.ref import combine_partials, decode_attention_ref
from repro_torch.kernels.sharded import slice_bounds

TOL = {torch.float32: dict(rtol=2e-5, atol=2e-5),
       torch.bfloat16: dict(rtol=3e-2, atol=3e-2)}
SHARD_TOL = 1e-5        # fp32 attention, split-KV against the whole cache
CACHE_TOL = dict(rtol=1e-3, atol=1e-3)   # tests/test_torch_lm.py CACHE_TOL
WAIT = 240              # seconds a spawned group may take, the whole of it
PROMPT, NEW, MAX_LEN = 22, 4, 48


def _qkv(rng, B, H, Hk, Smax, hd, dtype):
    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape)
                                .astype(np.float32)).to(dtype)
    return t(B, H, hd), t(B, Smax, Hk, hd), t(B, Smax, Hk, hd)


def _slices(q, k, v, lengths, R, window=None, softcap=None):
    """The cache cut into R slices of its sequence, each through the plain
    version with the slice's own lengths and starts: (o, lse) stacked."""
    Sl = k.shape[1] // R
    outs, lses = [], []
    for r in range(R):
        off = r * Sl
        end, start = slice_bounds(lengths, off, Sl, window)
        o, lse = decode_attention_ref(
            q, k[:, off:off + Sl], v[:, off:off + Sl], end, softcap=softcap,
            starts=start, return_lse=True)
        outs.append(o)
        lses.append(lse)
    return torch.stack(outs), torch.stack(lses)


# lengths over a 64-entry cache: empty, within the first slice of 4,
# on slice boundaries, across them, whole
LENGTHS = [0, 3, 4, 16, 17, 33, 63, 64]


@pytest.mark.parametrize("window", [None, 5, 13])
@pytest.mark.parametrize("softcap", [None, 5.0])
def test_plain_starts_and_lse_against_the_whole_cache(window, softcap):
    rng = np.random.default_rng(0)
    B = len(LENGTHS)
    q, k, v = _qkv(rng, B, 8, 2, 64, 16, torch.float32)
    lengths = torch.tensor(LENGTHS, dtype=torch.int32)
    want = decode_attention_ref(q, k, v, lengths, window=window,
                                softcap=softcap)
    o, lse = decode_attention_ref(q, k, v, lengths, window=window,
                                  softcap=softcap, return_lse=True,
                                  starts=torch.zeros_like(lengths))
    assert torch.equal(o, want)
    # the log-sum-exp, written out over the valid keys
    s = torch.einsum("bhd,bkhd->bhk", q, k.repeat_interleave(4, dim=2)) / 4.0
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    kpos = torch.arange(64)
    lo = (lengths - window).clamp(min=0) if window else torch.zeros_like(
        lengths)
    valid = (kpos < lengths[:, None]) & (kpos >= lo[:, None])
    direct = torch.logsumexp(s.masked_fill(~valid[:, None], -np.inf), -1)
    torch.testing.assert_close(lse, direct, **TOL[torch.float32])
    assert torch.isneginf(lse[0]).all() and not torch.isnan(lse).any()
    assert not o[0].any()
    # starts mask what lies before them: the row's cache from its start on
    starts = (lengths // 2).to(torch.int32)
    got = decode_attention_ref(q, k, v, lengths, softcap=softcap,
                               window=window, starts=starts)
    for b in range(B):
        s0 = int(starts[b])
        torch.testing.assert_close(got[b:b + 1], decode_attention_ref(
            q[b:b + 1], k[b:b + 1, s0:], v[b:b + 1, s0:], lengths[b:b + 1] - s0,
            softcap=softcap, window=window), **TOL[torch.float32])
    # shard by shard, recombined
    o_r, lse_r = _slices(q, k, v, lengths, 4, window, softcap)
    assert torch.isneginf(lse_r[1:, 1]).all()      # wholly in slice 0
    torch.testing.assert_close(combine_partials(o_r, lse_r), want,
                               **TOL[torch.float32])


@pytest.mark.parametrize("R", [1, 2, 4, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_combine_partials_equals_the_unsplit_call(R, dtype):
    rng = np.random.default_rng(R)
    B = len(LENGTHS)
    q, k, v = _qkv(rng, B, 4, 4, 64, 32, dtype)
    lengths = torch.tensor(LENGTHS, dtype=torch.int32)
    for window in (None, 9):
        want = decode_attention_ref(q, k, v, lengths, window=window)
        o_r, lse_r = _slices(q, k, v, lengths, R, window)
        got = combine_partials(o_r, lse_r)
        assert got.dtype == dtype and not torch.isnan(got).any()
        torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
        if R > 1:      # row 0 has no valid key in any slice
            assert torch.isneginf(lse_r[:, 0]).all() and not got[0].any()


def test_combine_partials_of_a_masked_slice_has_no_nan():
    rng = np.random.default_rng(5)
    o = torch.from_numpy(rng.standard_normal((3, 2, 4, 8)).astype(np.float32))
    lse = torch.tensor([[[0.5] * 4, [-np.inf] * 4],
                        [[-np.inf] * 4, [-np.inf] * 4],
                        [[1.5] * 4, [-np.inf] * 4]], dtype=torch.float32)
    got = combine_partials(o, lse)
    assert not torch.isnan(got).any() and not got[1].any()
    w = torch.tensor([np.exp(-1.0), 0.0, 1.0],
                     dtype=torch.float32)[:, None, None]
    torch.testing.assert_close(got[0], (w * o[:, 0]).sum(0) / w.sum(),
                               **TOL[torch.float32])


def test_wrapper_takes_starts_and_lse_on_the_cpu():
    rng = np.random.default_rng(3)
    q, k, v = _qkv(rng, 3, 4, 2, 20, 8, torch.float32)
    lengths = torch.tensor([20, 7, 0], dtype=torch.int32)
    starts = torch.tensor([5, 7, 0], dtype=torch.int32)
    o, lse = da_mod.decode_attention(q, k, v, lengths, starts=starts,
                                     return_lse=True)
    want = decode_attention_ref(q, k, v, lengths, starts=starts,
                                return_lse=True)
    assert torch.equal(o, want[0]) and torch.equal(lse, want[1])
    assert not o[1:].any() and torch.isneginf(lse[1:]).all()
    with pytest.raises(ValueError, match="starts must be"):
        da_mod.decode_attention(q, k, v, lengths, starts=starts[:2])


# -- across ranks: spawned gloo groups ----------------------------------------

def _spawn(fn, world: int, tmp_path, *args):
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    procs = [ctx.Process(target=fn, args=(r, world, str(tmp_path / "store"),
                                          out, *args))
             for r in range(world)]
    for p in procs:
        p.start()
    try:
        results = dict(out.get(timeout=WAIT) for _ in range(world))
    except queue.Empty:
        results = None
    for p in procs:
        p.join(timeout=60)
        if p.is_alive():
            p.kill()
    assert results is not None, "a rank gave no result in time"
    errors = {r: v for r, v in results.items() if isinstance(v, str)}
    assert not errors, errors
    return results


def reduce_cfg(cfg):
    """A reduced config with fewer kv heads than 16, as the registered LMs
    that split their caches on the sequence have (either package's)."""
    return cfg.replace(
        n_layers=len(cfg.pattern) * 2, d_model=64, n_heads=4, n_kv_heads=2,
        head_dim=16, d_ff=128, vocab=256, window=8 if cfg.window else None,
        query_pre_attn_scalar=16.0 if cfg.query_pre_attn_scalar else None,
        q_chunk=16, loss_seq_chunk=None, remat=False)


def _whole(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def _decode(params, cache, decode, tok, clen, prep):
    """``NEW`` greedy decode steps from ragged cache lengths ``clen``,
    starting from token ``tok``: the logits (numpy fp32) and the tokens."""
    logits, toks = [], []
    with torch.no_grad():
        for i in range(NEW):
            d = prep({"token": tok, "cache_len": clen + i})
            tok, out, cache = decode(params, cache, d["token"],
                                     d["cache_len"])
            tok = _whole(tok)
            logits.append(_whole(out).numpy())
            toks.append(tok)
    return logits, torch.cat(toks, 1).numpy()


def _attention_errors(mesh, seq_pl, rng):
    """The wrapper on fp32 DTensors, q replicated and k, v split on their
    sequence as ``seq_pl`` gives, against the plain version on the whole
    tensors: the largest difference over windows and softcaps."""
    from torch.distributed.tensor import DTensor, Replicate
    q, k, v = _qkv(rng, len(LENGTHS), 8, 2, 64, 16, torch.float32)
    lengths = torch.tensor(LENGTHS, dtype=torch.int32)
    rep = [Replicate()] * mesh.ndim
    dq = DTensor.from_local(q, mesh, rep, run_check=False)
    dk, dv = (DTensor.from_local(t, mesh, rep, run_check=False)
              .redistribute(mesh, seq_pl) for t in (k, v))
    errs = []
    for window, softcap in ((None, None), (13, None), (5, 5.0)):
        got = da_mod.decode_attention(dq, dk, dv, lengths, window=window,
                                      softcap=softcap).full_tensor()
        want = decode_attention_ref(q, k, v, lengths, window=window,
                                    softcap=softcap)
        errs.append((got - want).abs().max().item())
    return errs


def _split_rank(rank, world, store, out, arch, shape, params_path, batch):
    """One rank of a ``shape`` mesh: the attention on split DTensors, then
    the unsharded steps and the steps with the cache split on its sequence
    over the ``model`` dimension (1 x 4) or over both (2 x 2,
    ``act_kv_seq_full``), from the same weights (``params_path``'s, or the
    port's own fp32 draw)."""
    import traceback
    try:
        dist.init_process_group("gloo", init_method=f"file://{store}",
                                world_size=world, rank=rank)
        from torch.distributed.device_mesh import init_device_mesh
        from repro_torch.configs.base import ShapeConfig
        from repro_torch.launch.steps import (make_decode_step,
                                              make_prefill_step, rules_for,
                                              shard_args)
        from repro_torch.models import build_model, get_config
        from repro_torch.models import layers as L
        torch.set_num_threads(1)
        from torch.distributed.tensor import Replicate, Shard
        mesh = init_device_mesh("cpu", shape,
                                mesh_dim_names=("data", "model"))
        attn = _attention_errors(mesh, [Shard(1) if n > 1 else Replicate()
                                        for n in shape],
                                 np.random.default_rng(11))
        cfg = reduce_cfg(get_config(arch))
        model = build_model(cfg, device="cpu")
        params = torch.load(params_path) if params_path else \
            model.init(seed=3, dtype=torch.float32)
        tokens = torch.from_numpy(np.random.default_rng(7).integers(
            0, cfg.vocab, (batch, PROMPT), dtype=np.int32))
        clen = torch.tensor([PROMPT, PROMPT - 3][:batch], dtype=torch.int32)
        pshape = ShapeConfig("p", MAX_LEN, batch, "prefill")
        dshape = ShapeConfig("d", MAX_LEN, batch, "decode")
        pr, dr = (rules_for(s, multi_pod=False) for s in (pshape, dshape))
        if shape == (2, 2):             # the sequence over data x model
            pr, dr = (r.with_overrides(act_kv_seq=r.rules["act_kv_seq_full"])
                      for r in (pr, dr))
        with torch.no_grad():
            plain_prefill, _ = make_prefill_step(model)(
                params, model.init_cache(batch, MAX_LEN), {"tokens": tokens})
            a = shard_args(cfg, pshape, mesh, pr,
                           {"params": params,
                            "cache": model.init_cache(batch, MAX_LEN)})
            logits, cache = make_prefill_step(model, rules=pr, mesh=mesh)(
                a["params"], a["cache"], {"tokens": tokens})
        logits = logits.full_tensor()
        # the caches stack the layers of a group: (n, B, Smax, Hk, hd)
        split = [md for md, p in enumerate(L.tree_leaves(cache)[0]
                                            .placements) if p.is_shard(2)]
        # the decode steps from the sharded prefill's cache, sharded and not
        whole = L.tree_map(lambda t: t.full_tensor().clone(), cache)
        at = L.tree_map(lambda t: t.float().numpy(), whole)
        tok = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
        plain = _decode(params, whole, make_decode_step(model), tok, clen,
                        lambda d: d)
        sharded = _decode(a["params"], cache,
                          make_decode_step(model, rules=dr, mesh=mesh), tok,
                          clen, lambda d: shard_args(cfg, dshape, mesh, dr,
                                                     d))
        out.put((rank, dict(
            plain=plain, sharded=sharded, split=split, attn=attn,
            prefill=(logits.numpy(), plain_prefill.numpy()), cache=at,
            tokens=tokens.numpy(), clen=clen.numpy(), first=tok.numpy())))
    except Exception:                                   # noqa: BLE001
        out.put((rank, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _jax_steps(arch, np_params, cache, tok, clen, served):
    """The JAX model's decode steps on the same weights from the same cache
    (the port's, as bf16), fed the port's served tokens: its logits."""
    import jax
    import jax.numpy as jnp
    from repro.models import build_model as jax_build
    from repro.models import get_config as jax_config
    jmodel = jax_build(reduce_cfg(jax_config(arch)))
    jp = jax.tree.map(jnp.asarray, np_params)
    cache = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), cache)
    step = jax.jit(jmodel.decode_step)
    out = []
    for i in range(NEW):
        logits, cache = step(jp, jnp.asarray(tok), cache,
                             jnp.asarray(clen + i))
        out.append(np.asarray(logits))
        tok = served[:, i:i + 1]
    return out


def _hold_split_against_unsplit(res, shape):
    for rank, r in res.items():
        assert len(r["split"]) == (1 if shape == (1, 4) else 2), rank
        assert max(r["attn"]) <= SHARD_TOL, (rank, r["attn"])
        np.testing.assert_allclose(*r["prefill"], **CACHE_TOL)
        (pl, pt), (sl, st) = r["plain"], r["sharded"]
        np.testing.assert_array_equal(st, pt, err_msg=str(rank))
        for a, b in zip(sl, pl):
            np.testing.assert_allclose(a, b, rtol=SHARD_TOL, atol=SHARD_TOL)


@pytest.mark.parametrize("shape,batch", [((1, 4), 2), ((2, 2), 1)],
                         ids=["1x4_act_kv_seq", "2x2_act_kv_seq_full"])
@pytest.mark.parametrize("arch", ["granite-8b", "gemma2-9b"])
def test_decode_over_a_cache_split_on_its_sequence(tmp_path, arch, shape,
                                                   batch):
    """Four gloo ranks: the cache split 4 ways on its sequence (12 entries a
    rank; the rows' lengths cross a slice edge, gemma2-9b's windows of 8
    straddle one), each rank's slice through the plain version with its
    starts and lse, combined across the splitting dimensions.  The
    attention on split fp32 DTensors (lengths 0 to 64 over 64 entries, on
    and across the slice edges, with windows and a softcap) within
    SHARD_TOL of the whole cache's.  The sharded prefill's logits within
    the cache tolerance of the unsharded prefill's; then four greedy
    decode steps from its cache, sharded and unsharded: tokens equal and
    logits within SHARD_TOL.  JAX-free: it runs on a host without JAX."""
    res = _spawn(_split_rank, 4, tmp_path, arch, shape, None, batch)
    _hold_split_against_unsplit(res, shape)


@pytest.mark.parametrize("arch", ["granite-8b", "gemma2-9b"])
def test_split_decode_matches_the_jax_decode_step(tmp_path, arch):
    """The 1 x 4 case on the JAX model's weights: the sharded decode steps
    as above, and their logits within the cache tolerance of the JAX
    model's decode_step from the same cache on the same weights."""
    from repro.models import build_model as jax_build
    from repro.models import get_config as jax_config
    from repro_torch.convert import to_torch
    from test_torch_lm import jax_params
    jmodel = jax_build(reduce_cfg(jax_config(arch)))
    np_params = jax_params(jmodel, "float32")
    torch.save(to_torch(np_params, "cpu"), tmp_path / "params.pt")
    res = _spawn(_split_rank, 4, tmp_path, arch, (1, 4),
                 str(tmp_path / "params.pt"), 2)
    _hold_split_against_unsplit(res, (1, 4))
    r = res[0]
    want = _jax_steps(arch, np_params, r["cache"], r["first"], r["clen"],
                      r["sharded"][1])
    for got, w in zip(r["sharded"][0], want):
        np.testing.assert_allclose(got, w, **CACHE_TOL)
