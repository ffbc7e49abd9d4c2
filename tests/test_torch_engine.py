"""The port's ServingEngine: tests/test_serving.py's five scenarios on the
port's own engine, and the port's tokens against the JAX engine's.

The model is test_serving.py's: granite-8b cut to 2 layers, d_model 64, 4
query heads over 2 kv heads of head_dim 16, vocab 128, in fp32 on the CPU
(the kernels' plain versions).  The JAX model draws the parameters and
``convert.to_torch`` carries them over, so in fp32 the two engines' greedy
tokens are equal token for token: on the bucketed path (granite-8b) and on
the exact path (a reduced zamba2-2.7b, Mamba-2 with a shared attention
block).  The port's prefill writes the bucketed path's scratch cache in
place; two admission ticks whose buckets differ must still give the tokens
of one-at-a-time greedy decoding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import build_model as jax_build
from repro.models import get_config as jax_config
from repro.serving import Request as JaxRequest
from repro.serving import ServingEngine as JaxEngine

from repro_torch.convert import to_torch
from repro_torch.core.partition import PartitionConfig, Segment
from repro_torch.models import build_model, get_config
from repro_torch.models.layers import tree_leaves
from repro_torch.serving import KVCachePool, Request, ServingEngine
from repro_torch.serving.engine import RECURRENT_KINDS

SMALL = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
             d_ff=128, vocab=128, remat=False, q_chunk=32,
             loss_seq_chunk=None)
ZAMBA = dict(n_layers=12, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
             d_ff=128, vocab=128, ssm_state=8, ssm_head_dim=8, ssm_chunk=4,
             remat=False, q_chunk=32, loss_seq_chunk=None)


def _pair(arch, overrides):
    jmodel = jax_build(jax_config(arch).replace(**overrides))
    jparams = jmodel.init(jax.random.PRNGKey(0), jnp.float32)
    model = build_model(get_config(arch).replace(**overrides), device="cpu")
    params = to_torch(jax.tree.map(np.asarray, jparams), "cpu")
    return model.cfg, model, params, jmodel, jparams


@pytest.fixture(scope="module")
def small_model():
    return _pair("granite-8b", SMALL)


class TestPool:
    def test_acquire_release(self, small_model):
        _, model, _, _, _ = small_model
        pool = KVCachePool(model, width=2, max_len=16)
        a = pool.acquire(1)
        b = pool.acquire(2)
        assert {a, b} == {0, 1}
        assert pool.acquire(3) is None
        pool.release(a)
        assert pool.acquire(3) == a


class TestEngine:
    def test_serves_all_requests(self, small_model):
        cfg, model, params, _, _ = small_model
        eng = ServingEngine(model, params, width=2, max_len=32)
        rng = np.random.default_rng(1)
        reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab,
                                                   int(rng.integers(3, 8))),
                        max_new_tokens=4) for i in range(5)]
        for r in reqs:
            eng.submit(r)
        done = eng.run()
        assert len(done) == 5
        assert all(len(r.tokens) == 4 for r in done)
        assert all(r.first_token_at is not None for r in done)
        # measured throughput is reported for the completed run
        assert eng.stats.requests == 5
        assert eng.stats.tokens == 20
        assert eng.stats.wall_s > 0
        assert eng.measured_throughput_rps == pytest.approx(
            5 / eng.stats.wall_s)
        assert eng.stats.tokens_per_s == pytest.approx(20 / eng.stats.wall_s)

    def test_matches_unbatched_greedy(self, small_model):
        """Continuous-batched decode must equal one-at-a-time greedy."""
        cfg, model, params, _, _ = small_model
        rng = np.random.default_rng(2)
        prompts = [rng.integers(0, cfg.vocab, 6),
                   rng.integers(0, cfg.vocab, 4)]
        want = [_greedy(model, params, p, 5) for p in prompts]
        eng = ServingEngine(model, params, width=2, max_len=32)
        for i, p in enumerate(prompts):
            eng.submit(Request(rid=i, prompt=p, max_new_tokens=5))
        done = sorted(eng.run(), key=lambda r: r.rid)
        for r, w in zip(done, want):
            assert r.tokens == w, (r.rid, r.tokens, w)

    def test_width_from_operating_point(self, small_model):
        """An engine built from a Scission operating point admits exactly
        the batch size the cost model priced."""
        cfg, model, params, _, _ = small_model
        point = PartitionConfig(
            model="lm", segments=(Segment("cloud", 0, 3),), latency_s=0.1,
            compute_s={"cloud": 0.1}, comm_s=0.0, transfer_bytes=0.0,
            stage_compute_s=(0.1,), batch_size=3, replicas=(2,))
        eng = ServingEngine(model, params, max_len=32, config=point)
        assert eng.width == 3
        assert eng.pool.width == 3
        assert eng.config is point
        # explicit width always wins over the operating point
        eng2 = ServingEngine(model, params, width=2, max_len=32,
                             config=point)
        assert eng2.width == 2
        with pytest.raises(ValueError, match="width"):
            ServingEngine(model, params, width=0, max_len=32)

    def test_slot_reuse_more_requests_than_width(self, small_model):
        cfg, model, params, _, _ = small_model
        eng = ServingEngine(model, params, width=1, max_len=32)
        rng = np.random.default_rng(3)
        for i in range(3):
            eng.submit(Request(rid=i, prompt=rng.integers(0, cfg.vocab, 4),
                               max_new_tokens=3))
        done = eng.run()
        assert len(done) == 3


def _greedy(model, params, prompt, n_new, max_len=32):
    """Sequential greedy decoding of one prompt by prefill + decode_step."""
    cache = model.init_cache(batch=1, max_len=max_len)
    logits, cache = model.prefill(
        params, torch.as_tensor(prompt, dtype=torch.int32)[None], cache)
    toks = [int(torch.argmax(logits[0, -1]))]
    clen = len(prompt)
    for _ in range(n_new - 1):
        logits, cache = model.decode_step(
            params, torch.tensor([[toks[-1]]], dtype=torch.int32), cache,
            clen)
        toks.append(int(torch.argmax(logits[0, -1])))
        clen += 1
    return toks


def _serve(engine_cls, request_cls, model, params, prompts, n_new, **kw):
    eng = engine_cls(model, params, **kw)
    for i, p in enumerate(prompts):
        eng.submit(request_cls(rid=i, prompt=p, max_new_tokens=n_new))
    return eng, [r.tokens for r in sorted(eng.run(), key=lambda r: r.rid)]


@pytest.mark.parametrize("arch", ["granite-8b", "zamba2-2.7b"])
def test_tokens_equal_the_jax_engine(arch, small_model):
    """fp32: the port's engine yields the JAX engine's tokens, on the
    bucketed path (granite-8b) and the exact one (zamba2-2.7b)."""
    _, model, params, jmodel, jparams = small_model if arch == "granite-8b" \
        else _pair(arch, ZAMBA)
    rng = np.random.default_rng(4)
    # zamba2's exact prefill keeps to S % min(chunk, S) == 0
    lens = (3, 9, 5, 12) if arch == "granite-8b" else (4, 8, 12, 8)
    prompts = [rng.integers(0, model.cfg.vocab, n) for n in lens]
    eng, got = _serve(ServingEngine, Request, model, params, prompts, 6,
                      width=2, max_len=32)
    _, want = _serve(JaxEngine, JaxRequest, jmodel, jparams, prompts, 6,
                     width=2, max_len=32)
    assert (eng.prompt_buckets is None) == (arch == "zamba2-2.7b")
    assert got == want


def test_bucketed_ticks_reuse_the_scratch_in_place(small_model):
    """Two admission ticks over one scratch cache: the first admits long
    prompts (bucket 32), the second short ones (bucket 16), so the scratch
    still holds the first tick's rows past 16 when the second prefill
    runs.  Every request must still get one-at-a-time greedy's tokens."""
    cfg, model, params, _, _ = small_model
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab, n) for n in (30, 25, 7, 12)]
    want = [_greedy(model, params, p, 4, max_len=48) for p in prompts]
    eng, got = _serve(ServingEngine, Request, model, params, prompts, 4,
                      width=2, max_len=48, prompt_buckets=(16, 32))
    assert eng._scratch is not None
    assert got == want


def test_warmup_changes_no_engine_state(small_model):
    cfg, model, params, _, _ = small_model
    eng = ServingEngine(model, params, width=2, max_len=32)
    eng.submit(Request(rid=0, prompt=np.arange(5), max_new_tokens=2))
    pool = [t.clone() for t in tree_leaves(eng.pool.cache)]
    eng.warmup()
    assert all(torch.equal(a, b) for a, b in zip(pool,
                                                  tree_leaves(eng.pool.cache)))
    assert len(eng.queue) == 1 and not eng.active
    assert "mamba2" in RECURRENT_KINDS

