"""The published Zamba2 (``zamba2-7b``) in the port, on the CPU, against
the plain fp32 reference ``perfbench/reference/zamba2.py``.

A small published-form config: d 64, 4 attention heads of 32 over
concat(x, embedding), Mamba-2 heads of 16 in 2 groups of B and C, state
16, chunk 8, 9 layers with shared blocks before layers 1, 3, 6 and 8 (2
blocks in turn, LoRA rank 4), the gated norm after the gate, exact GELU,
RMSNorm eps 1e-5.  Seeded weights, every leaf moved off its init (norm
scales, decays, skips and biases drawn) so that no term vanishes.

Tolerances: fp32 on both sides, 1e-3 absolute and relative on logits of
magnitude ~4.5, for the same operations summed in another order (the
chunked SSD against the reference's chunks, the fused projections, 9
layers deep); seen 2.4e-4 at most, 2.9e-5 by relative norm.  The same
model in bf16 misses by 2.2-3.1 (0.42-0.55 by relative norm), three
orders of magnitude past it.  Caches are held in fp32 where the reference
is compared (the engine's bf16 K/V and conv state would add their
rounding).
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

from repro_torch import tracing
from repro_torch.kernels import ssd_scan as ssd_mod
from repro_torch.kernels.ref import ssd_ref
from repro_torch.launch.steps import count_params
from repro_torch.models import build_model, get_config
from repro_torch.models import layers as L
from repro_torch.models import ssm
from repro_torch.models.ssm import heads_of, ssd
from repro_torch.runtime.sharding import flatten, unflatten
from repro_torch.serving import Request, ServingEngine

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "perfbench"))
from reference import zamba2 as ref  # noqa: E402

SMALL = dict(n_layers=9, d_model=64, n_heads=4, n_kv_heads=4, head_dim=32,
             d_ff=128, vocab=97, ssm_state=16, ssm_head_dim=16, ssm_chunk=8,
             hybrid_layer_ids=(1, 3, 6, 8), shared_adapter_rank=4,
             query_pre_attn_scalar=16.0)
TOL = dict(rtol=1e-3, atol=1e-3)


def _small():
    cfg = get_config("zamba2-7b").replace(**SMALL)
    return cfg, build_model(cfg, device="cpu")


def _params(model, dtype=torch.float32):
    """Seeded weights with every leaf drawn away from its init."""
    params = model.init(seed=11, dtype=torch.float32)
    gen = torch.Generator().manual_seed(4)

    def move(t):
        return t + 0.1 * torch.randn(t.shape, generator=gen) \
            if t.shape[-1] != model.cfg.vocab else t

    return L.tree_map(lambda t: move(t).to(dtype), params)


def _fp32_cache(model, batch, max_len):
    return L.tree_map(lambda t: t.float(), model.init_cache(batch, max_len))


def _ref_logits(cfg, params, seqs, fp8=False):
    return ref.logits(L.tree_map(lambda t: t.float(), params),
                      dataclasses.asdict(cfg), seqs, fp8=fp8)


def test_the_config_is_the_published_model():
    cfg = get_config("zamba2-7b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.head_dim,
            cfg.d_ff, cfg.vocab) == (81, 3584, 32, 224, 14336, 32000)
    assert cfg.hybrid_layer_ids == (6, 11, 17, 23, 29, 35, 41, 47, 53, 59,
                                    65, 71, 77)
    assert (cfg.ssm_groups, cfg.ssm_chunk, cfg.n_shared_blocks,
            cfg.shared_adapter_rank, cfg.norm_eps) == (2, 256, 2, 128, 1e-5)
    assert cfg.query_pre_attn_scalar == cfg.head_dim / 2
    # 81 x 78.4e6 Mamba-2, 2 x 334e6 blocks, 13 x 16.9e6 adapters and
    # linears, 115e6 of embedding
    n = count_params(cfg)
    assert n == 7_356_749_648
    assert abs(cfg.params_estimate() - n) / n < 1e-3
    model = build_model(cfg, device="meta")
    spec = model.spec()
    assert spec["layers"]["s0_mamba2"]["core"]["w_in"].shape == \
        (81, 3584, 2 * 7168 + 2 * 2 * 64 + 112)
    assert spec["shared_blocks"]["attn"]["wq"].shape == (2, 7168, 32, 224)
    assert spec["shared_blocks"]["attn"]["wo"].shape == (2, 32, 224, 3584)
    assert spec["shared_adapters"]["lora_gate"].shape == (13, 128, 14336)
    assert spec["shared_adapters"]["linear"].shape == (13, 3584, 3584)
    cache = model.cache_spec(2, 4096)
    assert cache["shared_attn"]["k"].shape == (13, 2, 4096, 32, 224)
    assert cache["s0_mamba2"]["ssm"].shape == (81, 2, 112, 64, 64)


def test_the_simplified_zamba2_keeps_its_tree():
    """The new fields' defaults leave zamba2-2.7b's tree as it was."""
    spec = build_model(get_config("zamba2-2.7b"), device="meta").spec()
    assert "shared_blocks" not in spec and "shared_block" in spec
    assert spec["layers"]["s0_mamba2"]["core"]["w_in"].shape == \
        (9, 2560, 2 * 5120 + 2 * 64 + 80)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_forward_logits_match_the_reference(dtype):
    cfg, model = _small()
    params = _params(model, dtype)
    rng = np.random.default_rng(1)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 21),
                                           dtype=np.int32))
    hidden, _ = model.forward(params, tokens)
    got = L.unembed(params["embed"], hidden).float()
    want = _ref_logits(cfg, params, list(tokens))
    for g, w in zip(got, want):
        if dtype == torch.float32:
            torch.testing.assert_close(g, w, **TOL)
        else:   # the bf16 model lies far outside the fp32 tolerance
            assert (g - w).abs().max() > 100 * TOL["atol"]


@pytest.mark.parametrize("S", [13, 21])
def test_prefill_then_decode_match_the_reference(S):
    """A prompt of S tokens (no multiple of the chunk of 8) prefilled, then
    6 decode steps through the cache, each position's logits against the
    reference's full forward over the whole sequence."""
    cfg, model = _small()
    params = _params(model)
    rng = np.random.default_rng(S)
    seq = torch.from_numpy(rng.integers(0, cfg.vocab, (1, S + 6),
                                        dtype=np.int32))
    want = _ref_logits(cfg, params, [seq[0]])[0]
    cache = _fp32_cache(model, 1, 32)
    logits, cache = model.prefill(params, seq[:, :S], cache)
    torch.testing.assert_close(logits[0, -1], want[S - 1], **TOL)
    for i in range(S, S + 6):
        logits, cache = model.decode_step(
            params, seq[:, i:i + 1], cache,
            torch.tensor([i], dtype=torch.int32))
        torch.testing.assert_close(logits[0, -1], want[i], **TOL)


def test_the_engine_serves_ragged_prompts_to_the_references_logits(
        monkeypatch):
    """Exact admission (the recurrent model's) of prompts of 5, 13, 9 and
    21 tokens through a pool of 2 slots: every served token is the
    reference's best at its position within the tolerance, read in the
    reference's logits."""
    cfg, model = _small()
    params = _params(model)
    init = model.init_cache
    monkeypatch.setattr(model, "init_cache",
                        lambda batch, max_len: L.tree_map(
                            lambda t: t.float(), init(batch, max_len)))
    eng = ServingEngine(model, params, width=2, max_len=40,
                        prompt_buckets="auto")
    assert eng.prompt_buckets is None
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32)
               for n in (5, 13, 9, 21)]
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=p, max_new_tokens=7))
    done = sorted(eng.run(), key=lambda r: r.rid)
    assert [len(r.tokens) for r in done] == [7] * 4
    seqs = [torch.from_numpy(np.concatenate([r.prompt, r.tokens[:-1]]))
            for r in done]
    for r, lg in zip(done, _ref_logits(cfg, params, seqs)):
        lg = lg[len(r.prompt) - 1:]
        served = lg.gather(-1, torch.tensor(r.tokens)[:, None])[:, 0]
        assert (lg.max(-1).values - served).max() <= TOL["atol"]


def _recurrence(x, log_a, b, c):
    """The SSD recurrence step by step: s = exp(log_a) s + b xᵀ, y = c s;
    b, c per head."""
    B, S, H, P = x.shape
    s = torch.zeros(B, H, b.shape[-1], P, dtype=torch.float64)
    ys = []
    for t in range(S):
        s = s * torch.exp(log_a[:, t].double())[..., None, None] + \
            torch.einsum("bhn,bhp->bhnp", b[:, t].double(), x[:, t].double())
        ys.append(torch.einsum("bhn,bhnp->bhp", c[:, t].double(), s))
    return torch.stack(ys, 1), s


@pytest.mark.parametrize("S", [13, 8, 3])
def test_grouped_ssd_with_a_ragged_tail(S):
    """b, c of 2 groups of 2 heads against the per-head broadcast (bit for
    bit: the same values) and the step-by-step recurrence (1e-5: fp32
    chunks against float64 steps), y and the final state, at S = 13 (a
    partial last chunk of 5), 8 (whole) and 3 (shorter than a chunk)."""
    rng = np.random.default_rng(S)
    B, H, P, N, G = 2, 4, 8, 6, 2
    x = torch.from_numpy(rng.standard_normal((B, S, H, P)).astype(np.float32))
    log_a = -torch.from_numpy(
        np.abs(rng.standard_normal((B, S, H))).astype(np.float32)) * 0.3
    bc = torch.from_numpy(rng.standard_normal((B, S, 2 * G * N))
                          .astype(np.float32))
    b = bc[..., :G * N].unflatten(2, (G, N))
    c = bc[..., G * N:].unflatten(2, (G, N))
    y, fin = ssd(x, log_a, b, c, chunk=8)
    y_h, fin_h = ssd(x, log_a, heads_of(b, H), heads_of(c, H), chunk=8)
    assert torch.equal(y, y_h) and torch.equal(fin, fin_h)
    y_r, fin_r = _recurrence(x, log_a, heads_of(b, H), heads_of(c, H))
    torch.testing.assert_close(y.double(), y_r, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(fin.double(), fin_r, rtol=1e-5, atol=1e-5)
    # the plain version takes the groups as they are
    y_p, fin_p = ssd_ref(x, log_a, b, c, chunk=8)
    assert torch.equal(y, y_p) and torch.equal(fin, fin_p)


def test_spans_and_counters_of_one_prefill():
    """One prefill of 13 tokens (chunk 8, so 3 padded steps a layer): a
    ``zamba2.shared_block`` span per application with its block (k mod 2),
    application and tokens, a ``kernel.ssd_scan`` span per layer with its
    groups and padding, and the counters by as many."""
    cfg, model = _small()
    params = _params(model)
    tokens = torch.zeros((1, 13), dtype=torch.int32)
    before = tracing.counters()
    tracing.clear()
    tracing.start()
    try:
        model.prefill(params, tokens, _fp32_cache(model, 1, 16))
    finally:
        tracing.stop()
    recs = tracing.spans()
    tracing.clear()
    after = tracing.counters()
    blocks = [r for r in recs if r["name"] == "zamba2.shared_block"]
    assert [r["attrs"] for r in blocks] == [
        {"block": k % 2, "application": k, "tokens": 13} for k in range(4)]
    assert all(r["device_s"] is None for r in blocks)    # no card
    scans = [r for r in recs if r["name"] == "kernel.ssd_scan"]
    assert [r["attrs"] for r in scans] == [{"groups": 2, "pad": 3}] * 9
    assert after.get("shared_applications", 0) - \
        before.get("shared_applications", 0) == 4
    assert after.get("ssd_pad_positions", 0) - \
        before.get("ssd_pad_positions", 0) == 27


def test_hybrid_positions_need_single_mamba_layers():
    cfg = get_config("zamba2-7b").replace(**SMALL)
    with pytest.raises(ValueError, match="single Mamba-2 layers"):
        build_model(cfg.replace(pattern=(("mamba2", "mlp"),), n_layers=8),
                    device="cpu")


def _old_decode_step(state, x, log_a, b, c):
    """The one-token step as ``models/ssm.py`` ran it before the decode
    kernel (``ssd_decode_step``), given each head's maps."""
    a = torch.exp(log_a[:, 0].float())                  # (B, H)
    st = state * a[:, :, None, None] + torch.einsum(
        "bhn,bhp->bhnp", b[:, 0].float(), x[:, 0].float())
    B, H, N, P = st.shape
    y = torch.bmm(flatten(c[:, 0].float(), 0, 1)[:, None],
                  flatten(st, 0, 1))[:, 0]
    y = unflatten(y, 0, (B, H))
    return y[:, None].to(x.dtype), st


@pytest.mark.parametrize("out", ["none", "alias", "distinct"])
@pytest.mark.parametrize("G", [1, 2, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_decode_plain_route_is_the_old_step(dtype, G, out):
    """``ssd_decode`` on the CPU, b and c of G groups cut from one
    projection: y and the new state equal the old step's on the maps
    copied to each head bit for bit, whether the state goes into a new
    tensor (the input left as it was), into the input itself or into
    another buffer (which is returned)."""
    rng = np.random.default_rng(G)
    B, H, N, P = 3, 4, 6, 8
    state = torch.from_numpy(rng.standard_normal((B, H, N, P))
                             .astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((B, 1, H, P))
                         .astype(np.float32)).to(dtype)
    log_a = -torch.from_numpy(np.abs(rng.standard_normal((B, 1, H)))
                              .astype(np.float32))
    bc = torch.from_numpy(rng.standard_normal((B, 1, 2 * G * N + 3))
                          .astype(np.float32)).to(dtype)
    b = bc[..., :G * N].unflatten(2, (G, N))
    c = bc[..., G * N:2 * G * N].unflatten(2, (G, N))
    want_y, want_st = _old_decode_step(state, x, log_a, heads_of(b, H),
                                       heads_of(c, H))
    before = state.clone()
    dst = {"none": None, "alias": state,
           "distinct": torch.full_like(state, float("nan"))}[out]
    y, st = ssd_mod.ssd_decode(state, x, log_a, b, c, out=dst)
    assert torch.equal(y, want_y) and torch.equal(st, want_st)
    if dst is None:
        assert torch.equal(state, before)
    else:
        assert st is dst
        assert out == "alias" or torch.equal(state, before)


def test_ssd_decode_refuses_mismatched_shapes():
    """A state that is not (B, H, N, P) of x's rows and heads and b's N,
    groups that do not divide the heads, or an ``out`` of another shape or
    dtype: each raises before anything runs."""
    B, H, N, P = 2, 4, 6, 8
    state = torch.zeros(B, H, N, P)
    x, la = torch.zeros(B, 1, H, P), torch.zeros(B, 1, H)
    b = torch.zeros(B, 1, 2, N)
    for args in [(state[:, :3], x, la, b, b), (state, x, la, b[..., :5], b),
                 (state, x[:, :, :3], la[:, :, :3], b, b),
                 (state, torch.zeros(B, 2, H, P), torch.zeros(B, 2, H),
                  torch.zeros(B, 2, 2, N), torch.zeros(B, 2, 2, N)),
                 (state, x, la, torch.zeros(B, 1, 3, N),
                  torch.zeros(B, 1, 3, N))]:
        with pytest.raises(ValueError, match="expected state"):
            ssd_mod.ssd_decode(*args)
    for out in (torch.zeros(B, H, N, P, dtype=torch.bfloat16),
                torch.zeros(B, H, P, N)):
        with pytest.raises(ValueError, match="out must be"):
            ssd_mod.ssd_decode(state, x, la, b, b, out=out)


@pytest.mark.parametrize("B,H,P,tile", [
    (34, 112, 64, 64),      # zamba2-7b's chat tick: a CTA a head
    (4, 80, 64, 64),        # zamba2-2.7b's engine at width 4
    (4, 4, 384, 32),        # xlstm-125m's mLSTM at width 4: 192 CTAs
    (1, 4, 384, 32),        # one row: the smallest tile
    (2, 2, 80, 40),         # P of no power of 2: a half stays whole
    (1, 2, 16, 16)])        # P under the smallest tile
def test_decode_tile_follows_the_shape(B, H, P, tile):
    """The P columns a CTA of the decode kernel covers: all of P up to 128,
    halved while the grid is short of two CTAs an SM, never below 32 nor
    to a width of no multiple of 4."""
    assert ssd_mod.decode_tile(B, H, P) == tile
    assert tile % 4 == 0 and tile <= ssd_mod.DECODE_MAX_TILE


def test_decode_writes_the_cache_the_copying_step_wrote(monkeypatch):
    """Three decode steps of the reduced zamba2-7b over two rows of
    different lengths, from a prefill's cache: each Mamba-2 layer hands
    ``ssd_decode`` its cache slice as the state and as ``out`` (the update
    in place), and the logits and every cache leaf equal, bit for bit, a
    run where the kernel wrapper ignores ``out`` and returns a new state
    that ``apply_sublayer`` copies in, as before the decode kernel."""
    cfg, model = _small()
    params = _params(model)
    rng = np.random.default_rng(5)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 13),
                                           dtype=np.int32))
    _, cache = model.prefill(params, prompt, _fp32_cache(model, 2, 32))
    copied = L.tree_map(torch.clone, cache)
    real, in_place = ssm.ssd_decode, []

    def recording(state, x, log_a, b, c, *, out=None):
        in_place.append(out is state)
        return real(state, x, log_a, b, c, out=out)

    def copying(state, x, log_a, b, c, *, out=None):
        return real(state, x, log_a, b, c)

    lengths = torch.tensor([13, 9], dtype=torch.int32)
    for i in range(3):
        tok = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 1),
                                            dtype=np.int32))
        monkeypatch.setattr(ssm, "ssd_decode", recording)
        got, cache = model.decode_step(params, tok, cache, lengths + i)
        monkeypatch.setattr(ssm, "ssd_decode", copying)
        want, copied = model.decode_step(params, tok, copied, lengths + i)
        monkeypatch.undo()
        assert torch.equal(got, want), i
        for a, b in zip(L.tree_leaves(cache), L.tree_leaves(copied)):
            assert torch.equal(a, b), i
    assert in_place == [True] * 3 * cfg.n_layers
