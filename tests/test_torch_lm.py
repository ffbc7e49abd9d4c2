"""The port's decoder-only LMs against the JAX package's, on the CPU.

Nine configs, reduced as tests/test_models_smoke.py reduces them (two
groups, d_model 64, 4 heads of head_dim 16, vocab 256; MoE: 8 experts,
top-2 at most, a 64-wide shared expert, groups of 64): granite-8b,
gemma-7b, gemma2-9b (sliding window, attention and final softcaps, post
norms), starcoder2-15b (layernorm, qkv bias), zamba2-2.7b (Mamba-2 with a
shared attention block), internvl2-76b (with patch embeddings),
qwen2-moe-a2.7b (MoE with a shared expert), granite-moe-3b-a800m (MoE)
and xlstm-125m (mLSTM and sLSTM; forward and prefill start the sLSTM's
stabiliser differently, and each is held against its own).  The JAX
model draws the parameters; leaves it initialises to a constant (norm
scales, biases, the SSM's a_log, d_skip and dt_bias) get seeded numpy noise,
so that every parameter takes part; ``convert.to_torch`` carries them over.
``forward`` (unembedded), ``prefill`` and three ragged ``decode_step`` s
are compared logit for logit in fp32 at 1e-4 absolute plus relative.  Past
a cache the tolerance is 1e-3: both packages keep K/V caches in bf16, and a
k or v the two compute a float32 ulp apart can round to neighbouring bf16
values.  The bf16 cases are in test_torch_lm_bf16.py.  On the CPU the
port's kernels take their plain versions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import build_model as jax_build
from repro.models import get_config as jax_config
from repro.models import layers as JL
from repro.models.ssm import ssd as jax_ssd

from repro_torch.convert import to_torch
from repro_torch.kernels import ref
from repro_torch.models import build_model, get_config
from repro_torch.models import layers as TL
from repro_torch.models.ssm import ssd

TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
       "bfloat16": dict(rtol=3e-2, atol=3e-2)}    # one layer (ssd) only
CACHE_TOL = {"float32": dict(rtol=1e-3, atol=1e-3)}
ARCHS = ["granite-8b", "gemma-7b", "gemma2-9b", "starcoder2-15b",
         "zamba2-2.7b", "internvl2-76b", "qwen2-moe-a2.7b",
         "granite-moe-3b-a800m", "xlstm-125m"]
B, S, MAX_LEN = 2, 16, 32


def reduce_cfg(cfg):
    """tests/test_models_smoke.py's reduction, for the decoder-only
    configs (works on either package's ModelConfig)."""
    n_layers = (cfg.shared_attn_period * 2 if cfg.shared_attn_period
                else len(cfg.pattern) * 2)
    return cfg.replace(
        n_layers=n_layers, d_model=64, n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 4) if cfg.n_kv_heads < cfg.n_heads
        else 4,
        head_dim=16, d_ff=0 if cfg.d_ff == 0 else 128, vocab=256,
        window=8 if cfg.window else None,
        moe_experts=8 if cfg.moe_experts else 0,
        moe_top_k=min(cfg.moe_top_k, 2) if cfg.moe_top_k else 0,
        moe_shared_dff=64 if cfg.moe_shared_dff else 0, moe_group_size=64,
        ssm_state=8, ssm_head_dim=8, ssm_chunk=8,
        n_img_tokens=4 if cfg.n_img_tokens else 0, q_chunk=16,
        loss_seq_chunk=None,
        query_pre_attn_scalar=16.0 if cfg.query_pre_attn_scalar else None,
        remat=False)


def jax_params(jmodel, dtype, seed=0):
    """The JAX model's parameters with noise on its constant leaves, as
    numpy arrays (bf16 ones as ml_dtypes' bfloat16)."""
    rng = np.random.default_rng(seed)
    params = jmodel.init(jax.random.PRNGKey(seed), getattr(jnp, dtype))

    def leaf(a):
        a = np.asarray(a)
        if a.size and np.all(a == a.flat[0]):
            noise = 0.1 * rng.standard_normal(a.shape)
            a = (a.astype(np.float32) + noise).astype(a.dtype)
        return a

    return jax.tree.map(leaf, params)


def _models(arch, dtype):
    jcfg = reduce_cfg(jax_config(arch))
    tcfg = reduce_cfg(get_config(arch))
    jmodel, tmodel = jax_build(jcfg), build_model(tcfg, device="cpu")
    np_params = jax_params(jmodel, dtype)
    return (jcfg, jmodel, jax.tree.map(jnp.asarray, np_params), tmodel,
            to_torch(np_params, "cpu"))


def _close(got, want, dtype, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol[dtype])


def _inputs(cfg, seed=1):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, (B, S), dtype=np.int32)
    patches = (rng.standard_normal((B, cfg.n_img_tokens, cfg.d_model))
               .astype(np.float32) if cfg.n_img_tokens else None)
    return tokens, patches


def run_both(arch, dtype, jax_dtype=None):
    """Logits of ``forward`` (every position), ``prefill`` and three ragged
    ``decode_step`` s, from the port in ``dtype`` and from the JAX model in
    ``jax_dtype`` (default ``dtype``) on the same parameter values:
    ``[(stage, port logits, JAX logits), ...]``."""
    jcfg, jmodel, jp, tmodel, tp = _models(arch, dtype)
    jdt = getattr(jnp, jax_dtype or dtype)
    jp = jax.tree.map(lambda a: a.astype(jdt), jp)
    tokens, patches = _inputs(jcfg)
    jkw, tkw = {}, {}
    if patches is not None:
        jkw["patch_embeds"] = jnp.asarray(patches).astype(
            getattr(jnp, dtype)).astype(jdt)
        tkw["patch_embeds"] = torch.from_numpy(patches).to(
            getattr(torch, dtype))
    ttok = torch.from_numpy(tokens)
    out = []

    jh, _ = jax.jit(jmodel.forward)(jp, jnp.asarray(tokens), **jkw)
    th, _ = tmodel.forward(tp, ttok, **tkw)
    out.append(("forward",
                TL.unembed(tp["embed"], th, softcap=jcfg.final_softcap),
                JL.unembed(jp["embed"], jh, softcap=jcfg.final_softcap)))

    jcache = jmodel.init_cache(batch=B, max_len=MAX_LEN)
    jlog, jcache = jax.jit(jmodel.prefill)(jp, jnp.asarray(tokens), jcache,
                                           **jkw)
    tcache = tmodel.init_cache(batch=B, max_len=MAX_LEN)
    tlog, tcache = tmodel.prefill(tp, ttok, tcache, **tkw)
    out.append(("prefill", tlog, jlog))
    full = S + jcfg.n_img_tokens
    clen = np.array([full, full - 3], np.int32)     # row 1 drops 3 entries
    rng = np.random.default_rng(2)
    step = jax.jit(jmodel.decode_step)
    for i in range(3):
        tok = rng.integers(0, jcfg.vocab, (B, 1), dtype=np.int32)
        jlog, jcache = step(jp, jnp.asarray(tok), jcache, jnp.asarray(clen))
        tlog, tcache = tmodel.decode_step(tp, torch.from_numpy(tok), tcache,
                                          torch.from_numpy(clen))
        out.append((f"decode{i}", tlog, jlog))
        clen = clen + 1
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_prefill_decode_match_jax(arch):
    for stage, got, want in run_both(arch, "float32"):
        assert got.shape == want.shape, stage
        _close(got, want, "float32", TOL if stage == "forward" else CACHE_TOL)


def test_scalar_cache_len_decode_matches_jax():
    """A uniform (scalar) cache_len, as the reference's fleet cells pass."""
    jcfg, jmodel, jp, tmodel, tp = _models("granite-8b", "float32")
    tokens, _ = _inputs(jcfg)
    jcache = jmodel.init_cache(batch=B, max_len=MAX_LEN)
    _, jcache = jmodel.prefill(jp, jnp.asarray(tokens), jcache)
    tcache = tmodel.init_cache(batch=B, max_len=MAX_LEN)
    _, tcache = tmodel.prefill(tp, torch.from_numpy(tokens), tcache)
    tok = np.array([[3], [7]], np.int32)
    jlog, _ = jmodel.decode_step(jp, jnp.asarray(tok), jcache, jnp.int32(S))
    tlog, _ = tmodel.decode_step(tp, torch.from_numpy(tok), tcache, S)
    _close(tlog, jlog, "float32", CACHE_TOL)


def test_caches_are_written_in_place():
    _, _, _, tmodel, tp = _models("zamba2-2.7b", "float32")
    cache = tmodel.init_cache(batch=B, max_len=MAX_LEN)
    before = {id(t): t.data_ptr() for t in TL.tree_leaves(cache)}
    _, out = tmodel.prefill(tp, torch.zeros((B, S), dtype=torch.int32),
                            cache)
    assert out is cache
    assert {id(t): t.data_ptr() for t in TL.tree_leaves(out)} == before
    assert all(t.abs().sum() > 0 for t in TL.tree_leaves(cache))


def test_init_keeps_the_reference_tree_and_scales():
    """Same keys, shapes and stacking as the JAX pytree; the stacked init
    scale is the un-stacked leaf's fan-in (``wo``'s is H)."""
    for arch in ARCHS:
        jmodel = jax_build(reduce_cfg(jax_config(arch)))
        tmodel = build_model(reduce_cfg(get_config(arch)), device="cpu")
        jshapes = jax.tree.map(lambda s: tuple(s.shape),
                               jmodel.abstract_params())
        tshapes = TL.tree_map(lambda s: s.shape, tmodel.abstract_params())
        assert tshapes == jshapes, arch
    tmodel = build_model(reduce_cfg(get_config("granite-8b")).replace(
        n_heads=64, head_dim=4), device="cpu")
    params = tmodel.init(seed=3, dtype=torch.float32)
    wo = params["layers"]["s0_attn"]["attn"]["wo"]       # (G, H, hd, D)
    assert wo.std().item() == pytest.approx(1 / 8, rel=0.1)
    again = tmodel.init(seed=3, dtype=torch.float32)
    assert all(torch.equal(a, b) for a, b in zip(TL.tree_leaves(params),
                                                  TL.tree_leaves(again)))


def test_unported_kinds_raise_naming_the_roadmap():
    """No registered config is left unported: each builds (on ``meta``)
    and its parameter count is the JAX package's; only a kind neither
    package knows raises."""
    from repro.launch.steps import count_params as jax_count
    from repro_torch.launch.steps import count_params
    from repro_torch.models import config_names

    for arch in config_names():
        assert build_model(get_config(arch), device="meta") is not None
        assert count_params(get_config(arch)) == jax_count(jax_config(arch))
    bogus = get_config("granite-8b").replace(pattern=(("attn", "rnn"),))
    with pytest.raises(ValueError, match="unknown sub-layer kinds"):
        build_model(bogus, device="meta")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_shared_bc_and_initial_state_match_jax(dtype):
    """Head-shared b, c (Hb == 1) and a nonzero initial state: the kernel
    plus the exact linear terms against the reference's ``ssd``."""
    rng = np.random.default_rng(5)
    Bn, Sn, H, P, N, chunk = 2, 32, 4, 8, 8, 8
    x = rng.standard_normal((Bn, Sn, H, P)).astype(np.float32)
    la = -np.abs(rng.standard_normal((Bn, Sn, H))).astype(np.float32) * 0.3
    b = rng.standard_normal((Bn, Sn, 1, N)).astype(np.float32) * 0.5
    c = rng.standard_normal((Bn, Sn, 1, N)).astype(np.float32) * 0.5
    s0 = rng.standard_normal((Bn, H, N, P)).astype(np.float32)
    jd = getattr(jnp, dtype)
    jy, jfin = jax_ssd(jnp.asarray(x).astype(jd), jnp.asarray(la),
                       jnp.asarray(b).astype(jd), jnp.asarray(c).astype(jd),
                       chunk=chunk, initial_state=jnp.asarray(s0))
    td = getattr(torch, dtype)
    ty, tfin = ssd(torch.from_numpy(x).to(td), torch.from_numpy(la),
                   torch.from_numpy(b).to(td), torch.from_numpy(c).to(td),
                   chunk=chunk, initial_state=torch.from_numpy(s0))
    _close(ty, jy, dtype)
    _close(tfin, jfin, dtype)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        ssd(torch.zeros((1, 12, H, P)), torch.zeros((1, 12, H)),
            torch.zeros((1, 12, 1, N)), torch.zeros((1, 12, 1, N)), chunk=8)


@pytest.mark.parametrize("window,softcap", [(None, None), (8, None),
                                            (5, 30.0), (64, None)])
def test_windowed_decode_reference_matches_jax_sdpa_mask(window, softcap):
    """The port's plain decode (``decode_attention_ref`` with a window)
    computes what the reference's ``layers.sdpa`` computes for one new
    token at position ``length - 1`` over the cache."""
    rng = np.random.default_rng(6)
    Bn, Smax, H, Hk, hd = 4, 40, 4, 2, 16
    q = rng.standard_normal((Bn, H, hd)).astype(np.float32)
    k = rng.standard_normal((Bn, Smax, Hk, hd)).astype(np.float32)
    v = rng.standard_normal((Bn, Smax, Hk, hd)).astype(np.float32)
    lengths = np.array([1, 7, 23, 40], np.int32)
    want = JL.sdpa(jnp.asarray(q)[:, None], jnp.asarray(k), jnp.asarray(v),
                   q_pos=jnp.asarray(lengths - 1)[:, None],
                   k_pos=jnp.arange(Smax), causal=True, window=window,
                   softcap=softcap, k_len_valid=jnp.asarray(lengths))[:, 0]
    got = ref.decode_attention_ref(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(lengths), softcap=softcap, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)
    # the port's own plain attention gives the same
    tsdpa = TL.sdpa(torch.from_numpy(q)[:, None], torch.from_numpy(k),
                    torch.from_numpy(v),
                    q_pos=torch.from_numpy(lengths - 1)[:, None],
                    k_pos=torch.arange(Smax), causal=True, window=window,
                    softcap=softcap, k_len_valid=torch.from_numpy(lengths))
    np.testing.assert_allclose(tsdpa[:, 0].numpy(), np.asarray(want),
                               rtol=2e-5, atol=2e-5)
