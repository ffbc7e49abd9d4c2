"""The port's decode slice against the JAX package's, on the CPU.

Kernel: the port's ``ops.decode_attention`` (its plain version on CPU
tensors) is held against the JAX Pallas kernel run as tests/test_kernels.py
runs it (``interpret=True``) and against the JAX oracle
``repro.kernels.ref.decode_attention_ref`` on rows with ``length > 0`` (the
oracle gives NaN for ``length == 0``, where the Pallas kernel and the port
give zeros).  Inputs are made from a seed with numpy; tolerances fp32 2e-5,
bf16 3e-2 (tests/test_kernels.py:18-19).

Slice: both packages build the decode graph (decode attention -> dense ->
decode attention -> dense) at batch 2, 4 query heads, 2 kv heads, head_dim
32, a 300-entry cache, fp32.  The caches are the JAX node's own draws
(``jax.random.split(PRNGKey(seed), 2)`` normals) handed to the port as
``cache=``; the dense weights are the same numpy arrays.  Checked:
identical partition points, blocks and boundary bytes; an analytic
BenchmarkDB that is byte-identical JSON, and analytic and timed DBs that the
JAX package loads and queries to the same result; identical autotuned
block sizes under one deterministic hook; a two-segment pipeline allclose
to the JAX executor's at 2e-5.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
from repro.core.bench import BenchmarkDB as JaxBenchmarkDB
from repro.core.resources import CLOUD_VM as J_CLOUD_VM, EDGE_BOX_1 as J_EDGE
from repro.kernels import ref as jref
from repro.kernels.decode_attention import decode_attention as jax_decode
from repro.kernels.ops import decode_attention_node as j_decode_node
from repro.kernels.substrate import KernelAutotuner as JaxAutotuner
from repro.runtime.pipeline import PipelineExecutor as JaxExecutor

import repro_torch.core as tcore
from repro_torch import tracing
from repro_torch.convert import to_torch
from repro_torch.core.resources import CLOUD_VM, EDGE_BOX_1
from repro_torch.kernel_graph import decode_graph
from repro_torch.kernels import KernelAutotuner
from repro_torch.kernels import decode_attention as da_mod
from repro_torch.analysis.kernel_smem import kernel_smem_bytes
from repro_torch.kernels.ops import decode_attention, decode_attention_node
from repro_torch.kernels.substrate import DEFAULT_CANDIDATES, DEFAULT_PARAMS
from repro_torch.runtime import PipelineExecutor

TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=3e-2, atol=3e-2)}
H100_SMEM = 232448          # shared memory a block may opt in to on an H100


def _both(a, dtype):
    return (jnp.asarray(a).astype(getattr(jnp, dtype)),
            torch.from_numpy(a).to(getattr(torch, dtype)))


def _inputs(seed, B, Smax, H, Hk, hd, dtype, lengths=None):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, H, hd), (B, Smax, Hk, hd), (B, Smax, Hk, hd))]
    if lengths is None:
        lengths = rng.integers(1, Smax + 1, size=B)
    lengths = np.asarray(lengths, np.int32)
    pairs = [_both(a, dtype) for a in arrs]
    return ([p[0] for p in pairs] + [jnp.asarray(lengths)],
            [p[1] for p in pairs] + [torch.from_numpy(lengths)])


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("B,Smax,H,Hk,hd,dtype,lengths,softcap", [
    (2, 512, 4, 4, 64, "float32", None, None),        # tests/test_kernels.py
    (2, 512, 4, 4, 64, "bfloat16", None, None),
    (4, 1024, 8, 2, 64, "float32", None, None),
    (4, 1024, 8, 2, 64, "bfloat16", None, None),
    (1, 512, 8, 1, 128, "float32", None, None),
    (1, 512, 8, 1, 128, "bfloat16", None, None),
    (2, 300, 4, 2, 64, "float32", [300, 123], None),  # uneven cache
    (1, 200, 2, 2, 64, "float32", [200], None),       # Smax < block_k
    (4, 1024, 8, 2, 64, "float32", None, 50.0),       # softcap
    (4, 1024, 8, 2, 64, "bfloat16", None, 50.0),
    (3, 256, 4, 2, 32, "float32", [0, 1, 256], None),  # an empty row
])
def test_decode_attention_matches_jax(B, Smax, H, Hk, hd, dtype, lengths,
                                      softcap):
    (jq, jk, jv, jl), (tq, tk, tv, tl) = _inputs(5, B, Smax, H, Hk, hd,
                                                 dtype, lengths)
    got = decode_attention(tq, tk, tv, tl, softcap=softcap, block_k=256)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    _close(got, jax_decode(jq, jk, jv, jl, softcap=softcap, block_k=256,
                           interpret=True), TOL[dtype])
    rows = tl.numpy() > 0
    want = np.asarray(jref.decode_attention_ref(jq, jk, jv, jl,
                                                softcap=softcap), np.float32)
    _close(got[rows], want[rows], TOL[dtype])
    assert (got[~rows] == 0).all()


def test_decode_length_masking_exact():
    """Entries past ``length`` do not influence the output at all
    (tests/test_kernels.py:106-118)."""
    (jq, jk, jv, jl), (tq, tk, tv, tl) = _inputs(6, 1, 512, 2, 2, 64,
                                                 "float32", [300])
    got = decode_attention(tq, tk, tv, tl)
    tk2, tv2 = tk.clone(), tv.clone()
    tk2[:, 300:] = 1e6
    tv2[:, 300:] = -1e6
    got2 = decode_attention(tq, tk2, tv2, tl)
    np.testing.assert_allclose(got.numpy(), got2.numpy(), rtol=1e-6)
    jgot2 = jax_decode(jq, jk.at[:, 300:].set(1e6), jv.at[:, 300:].set(-1e6),
                       jl, interpret=True)
    _close(got2, jgot2, TOL["float32"])


def test_decode_wrapper_checks_shapes():
    q, k = torch.zeros(1, 6, 16), torch.zeros(1, 8, 4, 16)
    with pytest.raises(ValueError, match="multiple of Hk"):
        decode_attention(q, k, k, torch.zeros(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="lengths"):
        decode_attention(torch.zeros(1, 8, 16), k, k,
                         torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="softcap"):
        decode_attention(torch.zeros(1, 8, 16), k, k,
                         torch.zeros(1, dtype=torch.int32), softcap=0.0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("return_lse", [False, True])
def test_decode_out_receives_what_the_call_returns(dtype, return_lse):
    """``out=`` is returned in place of a new tensor, holding exactly what
    the call without it returns (a row of length 0 included); the lse is
    unchanged beside it."""
    _, (tq, tk, tv, tl) = _inputs(8, 3, 40, 4, 2, 16, dtype, [40, 7, 0])
    want = decode_attention(tq, tk, tv, tl, softcap=20.0,
                            return_lse=return_lse)
    out = torch.full_like(tq, float("nan"))
    got = decode_attention(tq, tk, tv, tl, softcap=20.0,
                           return_lse=return_lse, out=out)
    if return_lse:
        (got, lse), (want, want_lse) = got, want
        assert torch.equal(lse, want_lse)
    assert got is out
    assert torch.equal(out, want)


def test_decode_out_on_meta_is_returned():
    q = torch.empty(16, 32, 128, dtype=torch.bfloat16, device="meta")
    k = torch.empty(16, 4096, 8, 128, dtype=torch.bfloat16, device="meta")
    out = torch.empty_like(q)
    got = decode_attention(q, k, k, torch.empty(16, dtype=torch.int32,
                                                device="meta"), out=out)
    assert got is out


@pytest.mark.parametrize("bad", ["shape", "dtype", "strides"])
def test_decode_out_of_another_shape_dtype_or_layout_raises(bad):
    _, (tq, tk, tv, tl) = _inputs(9, 2, 24, 4, 2, 16, "float32")
    out = {"shape": torch.empty(2, 4, 8),
           "dtype": torch.empty(2, 4, 16, dtype=torch.bfloat16),
           "strides": torch.empty(2, 16, 4).transpose(1, 2)}[bad]
    with pytest.raises(ValueError, match="out must be"):
        decode_attention(tq, tk, tv, tl, out=out)


def test_decode_on_cpu_and_meta_launches_nothing():
    before = tracing.counters()
    (_, _, _, _), (tq, tk, tv, tl) = _inputs(7, 2, 40, 4, 2, 16, "float32")
    decode_attention(tq, tk, tv, tl)
    q = torch.empty(16, 32, 128, dtype=torch.bfloat16, device="meta")
    k = torch.empty(16, 4096, 8, 128, dtype=torch.bfloat16, device="meta")
    o = decode_attention(q, k, k, torch.empty(16, dtype=torch.int32,
                                              device="meta"))
    assert o.device.type == "meta" and o.shape == q.shape
    assert o.dtype == torch.bfloat16
    g = _torch_graph(_weights())          # traced on meta, run on the CPU
    x = torch.randn(SHAPE)
    for blk in tcore.fuse_blocks(g):
        x = blk.make_callable()(x)
    assert (tracing.counters() - before)["decode_attention_launches"] == 0


@pytest.mark.parametrize("ctas,n_tiles,sms,per_sm,want", [
    (128, 64, 132, 2, (2, 32)),    # granite-8b bf16, block_k 128: 2 per SM
    (128, 64, 132, 1, (1, 64)),    # block_k 256: 1 per SM, no split
    (128, 32, 132, 1, (1, 32)),    # fp32, block_k 128
    (8, 1, 132, 2, (1, 1)),        # one tile: no split
    (4, 3, 132, 8, (3, 1)),        # never more splits than tiles
    (1024, 16, 132, 2, (1, 16)),   # the grid is large enough unsplit
    (2, 1000, 114, 1, (56, 18)),
])
def test_decode_num_splits(ctas, n_tiles, sms, per_sm, want):
    """As many splits as one wave of resident CTAs holds, never more than
    tiles, the tiles shared out evenly."""
    nsplit, per = da_mod.num_splits(ctas, n_tiles, sms, per_sm)
    assert (nsplit, per) == want
    assert nsplit * per >= n_tiles > (nsplit - 1) * per
    assert nsplit == 1 or nsplit * ctas <= per_sm * sms


@pytest.mark.parametrize("block_k,stages", [(32, 3), (128, 3), (256, 5),
                                            (512, 9)])
def test_decode_ring_stages(block_k, stages):
    """The bf16 ring keeps block_k rows in flight beside the 64-row stage
    being multiplied, with at least 3 stages."""
    assert da_mod.ring_stages(block_k) == stages


def test_decode_split_plan_fills_one_wave(monkeypatch):
    """The launch plan at granite-8b widths from the occupancy the card
    reports (stubbed: 2 CTAs per SM at 108,800 B, 1 at 178,432 B, 132
    SMs); the bf16 route needs no workspace when the cache is not split."""
    per_sm = {108800: 2, 178432: 1, 139520: 1}
    monkeypatch.setattr(da_mod, "card_smem_limit", lambda d: H100_SMEM)
    monkeypatch.setattr(da_mod, "_sm_count", lambda i: 132)
    monkeypatch.setattr(da_mod, "_ctas_per_sm",
                        lambda *a: per_sm[a[-1]])
    da_mod._plan.cache_clear()
    dev = torch.device("cuda", 0)
    try:
        plan = da_mod._plan(dev, torch.bfloat16, 16, 4096, 32, 8, 128, 128)
        assert plan == dict(block_k=128, smem_bytes=108800, ctas_per_sm=2,
                            nsplit=2, tiles_per_split=32,
                            workspace_floats=16 * 8 * 2 * 16 * 130)
        plan = da_mod._plan(dev, torch.bfloat16, 16, 4096, 32, 8, 128, 256)
        assert (plan["nsplit"], plan["workspace_floats"]) == (1, 0)
        # fp32: block_k-row tiles, groups of 4 padded to 4
        plan = da_mod._plan(dev, torch.float32, 16, 4096, 32, 8, 128, 128)
        assert (plan["nsplit"], plan["tiles_per_split"]) == (1, 32)
        assert plan["workspace_floats"] == 16 * 8 * 1 * 4 * 130
        with pytest.raises(ValueError, match="shared memory"):
            da_mod._plan(dev, torch.bfloat16, 16, 4096, 32, 8, 128, 512)
    finally:
        da_mod._plan.cache_clear()


def test_decode_split_plan_with_a_window(monkeypatch):
    """With a sliding window the splits cover the tiles a row's window can
    touch (ceil(window / tile) + 1), not the whole cache: gemma2's window of
    4096 over an 8192-entry cache at head_dim 256 (block_k 128, one CTA per
    SM at 211,200 B), 4 rows of 8 kv heads."""
    monkeypatch.setattr(da_mod, "card_smem_limit", lambda d: H100_SMEM)
    monkeypatch.setattr(da_mod, "_sm_count", lambda i: 132)
    monkeypatch.setattr(da_mod, "_ctas_per_sm", lambda *a: 1)
    da_mod._plan.cache_clear()
    dev = torch.device("cuda", 0)
    try:
        assert da_mod.window_tiles(128, 64, None) == 128
        assert da_mod.window_tiles(128, 64, 4096) == 65
        assert da_mod.window_tiles(4, 64, 4096) == 4
        full = da_mod._plan(dev, torch.bfloat16, 4, 8192, 16, 8, 256, 128)
        win = da_mod._plan(dev, torch.bfloat16, 4, 8192, 16, 8, 256, 128,
                           4096)
        assert full["nsplit"] * full["tiles_per_split"] >= 128
        assert 65 <= win["nsplit"] * win["tiles_per_split"] < 128
        assert (win["nsplit"], win["tiles_per_split"]) == (4, 17)
    finally:
        da_mod._plan.cache_clear()


@pytest.mark.parametrize("window", [1, 5, 64])
def test_decode_window_plain_version_on_cpu(window):
    """On CPU tensors the wrapper takes its plain version with the window:
    keys before ``length - window`` do not matter, and a window past every
    length changes nothing."""
    rng = np.random.default_rng(8)
    q = torch.from_numpy(rng.standard_normal((3, 4, 16)).astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((3, 40, 2, 16))
                             .astype(np.float32)) for _ in range(2))
    lengths = torch.tensor([0, 20, 40], dtype=torch.int32)
    before = tracing.counters()
    got = da_mod.decode_attention(q, k, v, lengths, window=window)
    k2, v2 = k.clone(), v.clone()
    for row, n in enumerate(lengths.tolist()):
        k2[row, :max(n - window, 0)] = 1e3
        v2[row, :max(n - window, 0)] = -1e3
    assert torch.allclose(da_mod.decode_attention(q, k2, v2, lengths,
                                                  window=window), got)
    assert torch.equal(da_mod.decode_attention(q, k, v, lengths,
                                               window=4096),
                       da_mod.decode_attention(q, k, v, lengths))
    assert (got[0] == 0).all()
    assert (tracing.counters() - before)["decode_attention_launches"] == 0


def test_decode_node_draws_once_and_converts_once():
    node = decode_attention_node("a", cache_len=24, kv_heads=2, head_dim=16,
                                 batch=2, seed=3, device="cpu")
    again = decode_attention_node("b", cache_len=24, kv_heads=2,
                                  head_dim=16, batch=2, seed=3, device="cpu")
    other = decode_attention_node("c", cache_len=24, kv_heads=2,
                                  head_dim=16, batch=2, seed=4, device="cpu")
    q = torch.randn(2, 4, 16)
    assert torch.equal(node.apply(q), again.apply(q))
    assert not torch.equal(node.apply(q), other.apply(q))
    cache_for = inspect.getclosurevars(node.apply).nonlocals["cache_for"]
    qb = q.to(torch.bfloat16)
    k, v, lengths = cache_for(qb)
    assert k.dtype == v.dtype == torch.bfloat16
    assert cache_for(qb)[0] is k and cache_for(q)[0] is not k
    assert lengths.dtype == torch.int32 and lengths.tolist() == [24, 24]
    assert node.kernel_options == {"cache_len": 24, "kv_heads": 2,
                                   "head_dim": 16, "seed": 3}
    with pytest.raises(ValueError, match="cache must be"):
        decode_attention_node("d", cache_len=24, kv_heads=2, head_dim=16,
                              cache=(k, k[:, :8]), device="cpu")


# granite-8b widths: 16 sequences, 32 query heads, 8 kv heads, head_dim 128,
# a 4096-entry cache, bf16
GRANITE_Q = (16, 32, 128)
GRANITE_OPTS = {"cache_len": 4096, "kv_heads": 8, "head_dim": 128}


@pytest.mark.parametrize("dtype,block_k,want", [
    # bf16: the 16-row query tile and a ring of block_k / 64 + 1 stages
    (torch.bfloat16, 128, 108800),
    (torch.bfloat16, 256, 178432),
    (torch.bfloat16, 512, 317696),
    (torch.float32, 128, 139520),
    (torch.float32, 256, 272640),
])
def test_decode_smem_footprint(dtype, block_k, want):
    q = torch.empty(GRANITE_Q, dtype=dtype, device="meta")
    assert kernel_smem_bytes("decode_attention", {"block_k": block_k}, (q,),
                             GRANITE_OPTS) == want


def test_decode_autotuner_prunes_before_measuring():
    measured = []

    def measure(fn, args):
        measured.append(inspect.getclosurevars(fn).nonlocals["p"])
        return float(len(measured))

    zero = torch.zeros(()).expand(16, 4096, 8, 128)  # never materialised
    node = decode_attention_node("attn", batch=16, cache=(zero, zero),
                                 device="cpu", **GRANITE_OPTS)
    tuner = KernelAutotuner(measure=measure, smem_limit=H100_SMEM,
                            device="cpu")
    rec = tuner.tune_node(node, in_specs=[
        tcore.TensorSpec(GRANITE_Q, torch.bfloat16)])
    assert DEFAULT_CANDIDATES["decode_attention"] == \
        [{"block_k": 128}, {"block_k": 256}, {"block_k": 512}]
    assert DEFAULT_PARAMS["decode_attention"] == {"block_k": 256}
    assert measured == [{"block_k": 128}, {"block_k": 256}]
    assert rec.pruned == {'{"block_k": 512}': 317696.0}
    assert rec.params == {"block_k": 128} == node.kernel_params
    assert rec.vmem_limit == H100_SMEM


# -- the slice: decode graph parity --------------------------------------

B, H, HK, HD, CACHE = 2, 4, 2, 32, 300
SHAPE = (B, H, HD)


def _weights():
    rng = np.random.default_rng(0)
    return {n: (rng.standard_normal((HD, HD)) * 0.05).astype(np.float32)
            for n in ("mlp0", "mlp1")}


def _jax_cache(seed):
    """The cache the JAX node draws for ``seed`` (ops.py:87-89)."""
    ks = jax.random.split(jax.random.PRNGKey(seed), 2)
    return [np.asarray(jax.random.normal(k, (B, CACHE, HK, HD))) for k in ks]


def _jax_graph(w):
    def mlp(name):
        return jcore.LayerNode(name=name, kind="dense",
                               apply=lambda x, w=jnp.asarray(w[name]):
                               jnp.tanh(x @ w),
                               flops=2.0 * HD * HD, param_bytes=4 * HD * HD)

    def attn(name, seed):
        return j_decode_node(name, cache_len=CACHE, kv_heads=HK,
                             head_dim=HD, batch=B, seed=seed, interpret=True)

    return jcore.linear_graph(
        "decode-demo", jax.ShapeDtypeStruct(SHAPE, jnp.float32),
        [attn("attn0", 0), mlp("mlp0"), attn("attn1", 1), mlp("mlp1")])


def _torch_graph(w):
    caches = {name: tuple(to_torch(_jax_cache(seed), "cpu"))
              for name, seed in (("attn0", 0), ("attn1", 1))}
    return decode_graph(tcore.TensorSpec(SHAPE, torch.float32),
                        to_torch(w, "cpu"), cache_len=CACHE, kv_heads=HK,
                        head_dim=HD, caches=caches, device="cpu")


@pytest.fixture(scope="module")
def graphs():
    w = _weights()
    return _jax_graph(w), _torch_graph(w)


def _resources(core, edge, cloud):
    return [core.Resource("edge1", "edge", edge, speed_factor=2.0),
            core.Resource("cloud", "cloud", cloud, speed_factor=1.0)]


def _ranked(core, db, resources):
    net = core.NetworkModel(default=core.Link("wired", 0.005, 1e8))
    engine = core.QueryEngine(db, resources, net, source="edge1",
                              input_bytes=4.0 * np.prod(SHAPE))
    configs = engine.run(core.Query(top_n=8)).configs
    return [(tuple((s.resource, s.start, s.end) for s in c.segments),
             c.latency_s, c.transfer_bytes, c.describe()) for c in configs]


def test_decode_graph_structure_matches(graphs):
    jg, tg = graphs
    assert tg.partition_points() == jg.partition_points() == [1, 2, 3]
    jb, tb = jcore.fuse_blocks(jg), tcore.fuse_blocks(tg)
    assert [b.node_ids for b in tb] == [b.node_ids for b in jb]
    assert [b.output_bytes for b in tb] == [b.output_bytes for b in jb]
    assert [b.flops for b in tb] == [b.flops for b in jb]
    assert [b.param_bytes for b in tb] == [b.param_bytes for b in jb]
    assert [n.kernel_options for n in tg.nodes if n.kernel] == \
        [n.kernel_options for n in jg.nodes if n.kernel]


def test_decode_analytic_db_is_identical_and_loads_in_jax(graphs):
    jg, tg = graphs
    jres = _resources(jcore, J_EDGE, J_CLOUD_VM)
    tres = _resources(tcore, EDGE_BOX_1, CLOUD_VM)
    jdb = jcore.benchmark_model(jg, jres, jcore.AnalyticProvider(),
                                batch_sizes=(1, 4))
    tdb = tcore.benchmark_model(tg, tres, tcore.AnalyticProvider(),
                                batch_sizes=(1, 4))
    assert tdb.to_json() == jdb.to_json()
    loaded = JaxBenchmarkDB.from_json(tdb.to_json())
    assert _ranked(jcore, loaded, jres) == _ranked(tcore, tdb, tres)


def test_decode_timed_db_loads_in_jax_with_same_query(graphs):
    _, tg = graphs
    before = tracing.counters()
    tres = _resources(tcore, EDGE_BOX_1, CLOUD_VM)
    tuner = KernelAutotuner(candidates={"decode_attention":
                                        [{"block_k": 128}]},
                            runs=1, device="cpu")
    tdb = tcore.benchmark_model(
        tg, tres, tcore.TimingProvider(tuner=tuner, device="cpu"), runs=1)
    loaded = JaxBenchmarkDB.from_json(tdb.to_json())
    jres = _resources(jcore, J_EDGE, J_CLOUD_VM)
    assert _ranked(jcore, loaded, jres) == _ranked(tcore, tdb, tres)
    tuned = [r.tuned_params for r in loaded.records["cloud"]]
    assert tuned == [r.tuned_params for r in tdb.records["cloud"]]
    assert {"attn0", "attn1"} <= {k for t in tuned for k in t}
    assert (tracing.counters() - before)["decode_attention_launches"] == 0


def _hook(fn, args):
    """Deterministic cost: block_k 128 wins (the default is 256)."""
    return 1.0 + abs(inspect.getclosurevars(fn).nonlocals["p"]["block_k"]
                     - 128)


def test_decode_autotuners_pick_identical_params():
    jg, tg = _jax_graph(_weights()), _torch_graph(_weights())
    jt = JaxAutotuner(measure=_hook)
    tt = KernelAutotuner(measure=_hook, device="cpu")
    for res in ("edge1", "cloud"):
        for jb, tb in zip(jcore.fuse_blocks(jg), tcore.fuse_blocks(tg)):
            jrecs = jt.tune_block(jb, resource=res)
            trecs = tt.tune_block(tb, resource=res)
            assert [r.params for r in trecs] == [r.params for r in jrecs]
            assert [r.shape_key for r in trecs] == \
                [r.shape_key for r in jrecs]
            assert tt.params_for_block(tb) == jt.params_for_block(jb)
    assert {n.name: n.kernel_params for n in tg.nodes if n.kernel} == \
        {"attn0": {"block_k": 128}, "attn1": {"block_k": 128}}


def test_decode_two_segment_pipeline_matches_jax(graphs):
    jg, tg = graphs
    x = np.random.default_rng(1).standard_normal(SHAPE).astype(np.float32)

    def config(core):
        segs = (core.Segment("edge1", 0, 1), core.Segment("cloud", 2, 3))
        return core.PartitionConfig("decode-demo", segs, 0.0, {}, 0.0, 0.0)

    jy, jt = JaxExecutor(
        jg, config(jcore), jcore.NetworkModel(
            default=jcore.Link("wired", 0.005, 1e8)),
        source="edge1").run(x, collect_timing=True)
    ty, tt = PipelineExecutor(
        tg, config(tcore), tcore.NetworkModel(
            default=tcore.Link("wired", 0.005, 1e8)),
        source="edge1", device="cpu").run(torch.from_numpy(x),
                                          collect_timing=True)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=2e-5,
                               atol=2e-5)
    assert [(t.resource, t.bytes_in, t.comm_in_s) for t in tt] == \
        [(t.resource, t.bytes_in, t.comm_in_s) for t in jt]
