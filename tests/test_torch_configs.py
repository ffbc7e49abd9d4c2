"""The port's config registry and serving-time tuned parameters against the
JAX package's, on the CPU.

Registry: the same config names, and every config dataclass equal to the
reference's field by field.  Tuned parameters: one BenchmarkDB, written by
the JAX package and read by both, adopted by both ``adopt_tuned_params``
in fp32 and bf16 (whose alignment rejects a block size of 8), gives the
same adopted mapping and ``serving_param`` values.  The port's LM layers
launch the kernels with the wrappers' defaults before an adoption and with
the adopted sizes after it (the kernels' wrappers are replaced by recorders
for that); Mamba-2 keeps its config's pinned chunk.  The wrappers halve the
sizes left to them where the card's shared memory (stubbed at an H100's)
cannot hold the tiles, and keep the sizes they are given.
"""

import dataclasses

import pytest
import torch

from repro.core.bench import BenchmarkDB as JaxDB
from repro.core.bench import BlockBenchmark as JaxRecord
from repro.kernels import substrate as jsub
from repro.models import config_names as jax_names
from repro.models import get_config as jax_config

from repro_torch.core.bench import BenchmarkDB
from repro_torch.kernels import decode_attention as da_mod
from repro_torch.kernels import flash_attention as fa_mod
from repro_torch.kernels import substrate as tsub
from repro_torch.models import build_model, config_names, get_config
from repro_torch.models import layers as TL
from repro_torch.models import ssm as TS


# configurations the port runs that the reference has no model for: the
# published Zamba2-7B (its shared blocks over concat(x, embedding), per
# application LoRA, grouped Mamba-2), held against
# perfbench/reference/zamba2.py by tests/test_torch_zamba2.py
PORT_ONLY = {"zamba2-7b"}


def test_config_names_equal_the_reference():
    assert sorted(set(config_names()) - PORT_ONLY) == jax_names()
    assert PORT_ONLY <= set(config_names())


@pytest.mark.parametrize("name", jax_names())
def test_config_equals_the_reference_field_by_field(name):
    """Every field the reference has, equal; the port's own fields (the
    published Zamba2's mechanisms, the norm's epsilon) at their defaults,
    which keep the reference's behaviour."""
    want = dataclasses.asdict(jax_config(name))
    got = dataclasses.asdict(get_config(name))
    assert {k: got[k] for k in want} == want
    defaults = {f.name: f.default for f in dataclasses.fields(
        type(get_config(name))) if f.name not in want}
    assert {k: got[k] for k in defaults} == defaults
    assert get_config(name).group_kinds == jax_config(name).group_kinds
    assert get_config(name).n_groups == jax_config(name).n_groups


def _db_json() -> str:
    tuned = [{"attn": {"block_q": 64, "block_k": 256},
              "dec": {"block_k": 512}},
             {"ssd": {"chunk": 64}, "odd": {"block_q": 8, "block_k": 8},
              "other": {"unknown": 3}}]
    db = JaxDB(model="lm", n_blocks=2)
    for res in ("cloud", "edge"):
        db.records[res] = [JaxRecord(block=i, resource=res, mean_time_s=1e-3,
                                     std_time_s=0.0, output_bytes=64, runs=1,
                                     tuned_params=t)
                           for i, t in enumerate(tuned)]
    return db.to_json()


@pytest.fixture
def clean():
    jsub.clear_tuned_params()
    tsub.clear_tuned_params()
    yield
    jsub.clear_tuned_params()
    tsub.clear_tuned_params()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adopt_tuned_params_matches_the_reference(clean, dtype):
    s = _db_json()
    want = jsub.adopt_tuned_params(JaxDB.from_json(s), dtype=dtype)
    got = tsub.adopt_tuned_params(BenchmarkDB.from_json(s), dtype=dtype)
    assert got == want
    # the later block's 8 x 8 wins in fp32; bf16's alignment rejects it
    assert got["flash_attention"] == ({"block_q": 8, "block_k": 8}
                                      if dtype == "float32" else
                                      {"block_q": 64, "block_k": 256})
    for kernel, name, fallback in [("flash_attention", "block_q", 512),
                                   ("flash_attention", "block_k", 128),
                                   ("decode_attention", "block_k", 256),
                                   ("ssd_scan", "chunk", 128)]:
        assert tsub.serving_param(kernel, name, fallback) == \
            jsub.serving_param(kernel, name, fallback)
    assert tsub.kernel_for_params({"chunk": 1}) == "ssd_scan"
    assert tsub.kernel_for_params({"x": 1}) is None


def test_model_kernel_calls_use_the_adopted_sizes(clean, monkeypatch):
    seen = []

    def recorder(kernel, real):
        # the sizes a launch would use: the wrappers choose those the layers
        # leave None (fa_mod.block_sizes, da_mod.block_size)
        def call(*args, **kw):
            q, k = args[0], args[2] if kernel == "ssd" else args[1]
            if kernel == "flash":
                bq, bk = fa_mod.block_sizes(q, k, kw.get("block_q"),
                                            kw.get("block_k"))
                sizes = {"block_q": bq, "block_k": bk}
            elif kernel == "decode":
                sizes = {"block_k": da_mod.block_size(q, k,
                                                      kw.get("block_k"))}
            else:
                sizes = {"chunk": kw["chunk"]}
            seen.append((kernel, sizes))
            return real(*args, **kw)
        return call

    monkeypatch.setattr(TL, "flash_attention",
                        recorder("flash", TL.flash_attention))
    monkeypatch.setattr(TL, "decode_attention",
                        recorder("decode", TL.decode_attention))
    monkeypatch.setattr(TS, "ssd_scan", recorder("ssd", TS.ssd_scan))
    cfg = get_config("zamba2-2.7b").replace(
        n_layers=6, d_model=32, n_heads=2, n_kv_heads=2, head_dim=16,
        d_ff=64, vocab=64, ssm_state=8, ssm_head_dim=8, ssm_chunk=8)
    model = build_model(cfg, device="cpu")
    params = model.init(seed=0, dtype=torch.float32)
    cache = model.init_cache(batch=1, max_len=16)

    def run():
        seen.clear()
        model.prefill(params, torch.zeros((1, 8), dtype=torch.int32), cache)
        model.decode_step(params, torch.zeros((1, 1), dtype=torch.int32),
                          cache, 8)
        return sorted({(k, tuple(sorted(v.items()))) for k, v in seen})

    assert run() == [("decode", (("block_k", 256),)),
                     ("flash", (("block_k", 128), ("block_q", 128))),
                     ("ssd", (("chunk", 8),))]      # cfg.ssm_chunk, pinned
    tsub.adopt_tuned_params(BenchmarkDB.from_json(_db_json()),
                            dtype="bfloat16")
    assert run() == [("decode", (("block_k", 512),)),
                     ("flash", (("block_k", 256), ("block_q", 64))),
                     ("ssd", (("chunk", 8),))]
    # an unpinned ssd resolves the adopted chunk
    x = torch.zeros((1, 64, 2, 4))
    seen.clear()
    TS.ssd(x, torch.zeros((1, 64, 2)), torch.zeros((1, 64, 1, 4)),
           torch.zeros((1, 64, 1, 4)))
    assert seen == [("ssd", {"chunk": 64})]


H100_SMEM = 232448          # shared memory a block may opt in to on an H100


@pytest.mark.parametrize("adopted,flash,decode", [
    (False, (128, 64), 128),        # defaults 128 x 128 and 256
    (True, (64, 64), 128),          # adopted 64 x 256 and 512
])
def test_wrappers_fit_the_sizes_left_to_them_to_the_card(
        clean, monkeypatch, adopted, flash, decode):
    """bf16 at head_dim 256 (the gemma configs'): flash's tiles of 128 x
    128 (337,920 B) and decode's ring at block_k 256 (346,368 B) exceed an
    H100's 232,448 B, so the wrappers halve them, block_k first; sizes
    given explicitly are kept (a launch then refuses them); at head_dim 128
    the defaults fit as they are."""
    for mod in (fa_mod, da_mod):
        monkeypatch.setattr(mod, "card_smem_limit", lambda d: H100_SMEM)
    if adopted:
        tsub.adopt_tuned_params(BenchmarkDB.from_json(_db_json()),
                                dtype="bfloat16")
    q = torch.zeros((1, 4096, 16, 256), dtype=torch.bfloat16)
    k = torch.zeros((1, 4096, 8, 256), dtype=torch.bfloat16)
    q1, ck = q[:, 0], k
    assert fa_mod.block_sizes(q, k) == flash
    assert fa_mod.smem_bytes(dict(zip(("block_q", "block_k"), flash)),
                             (q.shape, k.shape), q.dtype) <= H100_SMEM
    assert da_mod.block_size(q1, ck) == decode
    assert fa_mod.block_sizes(q, k, 128, 128) == (128, 128)
    assert fa_mod.block_sizes(q, k, block_q=128) == (128, 64)
    assert da_mod.block_size(q1, ck, 256) == 256
    if not adopted:
        assert fa_mod.block_sizes(q[..., :128], k[..., :128]) == (128, 128)
        assert da_mod.block_size(q1[..., :128], ck[..., :128]) == 256
