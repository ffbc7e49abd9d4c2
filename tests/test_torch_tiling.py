"""The port's Hopper tile-alignment analysis (``repro_torch.analysis.tiling``,
SCN204-207) on the CPU, through the autotuner's ``tile_check`` and
``adopt_tuned_params``.

The bf16 routes run whole tiles (flash ``block_q`` 32 and ``block_k`` 64
rows, decode 64-row ring stages, SSD 16-step chunks), the fp32 routes cut
tiles to the sequence; a candidate the launch would refuse is pruned with
the wrapper's own reason, which ``check_launch`` gives and ``_launch``
raises.
"""

import json
import math

import pytest
import torch

from repro_torch.analysis.diagnostics import ERROR, INFO, WARNING
from repro_torch.analysis.kernel_smem import H100_SMEM_PER_BLOCK
from repro_torch.analysis.tiling import (WASTE_THRESHOLD, analyze_tiling,
                                         lint_tiling, min_tile,
                                         misaligned_candidates,
                                         misaligned_params)
from repro_torch.core.bench import BenchmarkDB, BlockBenchmark
from repro_torch.kernels import KernelAutotuner, _build
from repro_torch.kernels import decode_attention as da_mod
from repro_torch.kernels import flash_attention as fa_mod
from repro_torch.kernels import ssd_scan as ssd_mod
from repro_torch.kernels.substrate import (adopt_tuned_params,
                                           clear_tuned_params, serving_param)

BF16, F32 = torch.bfloat16, torch.float32


def _meta(*shape, dtype=BF16):
    return torch.empty(shape, dtype=dtype, device="meta")


def _codes(diags):
    return [(d.code, d.severity) for d in diags]


def test_min_tile_by_kernel_and_dtype():
    assert min_tile("flash_attention", BF16) == {"block_q": 32, "block_k": 64}
    assert min_tile("decode_attention", "bfloat16") == {"block_k": 64}
    assert min_tile("ssd_scan", BF16) == {"chunk": 16}
    assert min_tile("flash_attention", F32) == {"block_q": 1, "block_k": 1}
    assert min_tile("ssd_scan", "float32") == {"chunk": 1}
    assert min_tile("mystery", BF16) == {}


@pytest.mark.parametrize("kernel,params,args,misaligned", [
    ("flash_attention", {"block_q": 64, "block_k": 128},
     (_meta(1, 1024, 4, 64),), {}),
    ("flash_attention", {"block_q": 48, "block_k": 100},
     (_meta(1, 1024, 4, 64),), {"block_q": (48, 32), "block_k": (100, 64)}),
    # fp32 cuts tiles to the sequence: nothing is padded
    ("flash_attention", {"block_q": 48, "block_k": 100},
     (_meta(1, 1024, 4, 64, dtype=F32),), {}),
    # a block over the whole sequence is the sequence's remainder (SCN205)
    ("flash_attention", {"block_q": 64, "block_k": 64},
     (_meta(1, 40, 4, 64),), {}),
    ("decode_attention", {"block_k": 100},
     (_meta(2, 8, 64), _meta(2, 4096, 2, 64), _meta(2, 4096, 2, 64),
      _meta(2, dtype=torch.int32)), {"block_k": (100, 64)}),
    ("decode_attention", {"block_k": 100},
     (_meta(2, 8, 64, dtype=F32), _meta(2, 4096, 2, 64, dtype=F32),
      _meta(2, 4096, 2, 64, dtype=F32), _meta(2, dtype=torch.int32)), {}),
    ("ssd_scan", {"chunk": 40}, (_meta(1, 256, 2, 32),), {"chunk": (40, 16)}),
    ("ssd_scan", {"chunk": 40}, (_meta(1, 256, 2, 32, dtype=F32),), {}),
])
def test_misalignment_by_route(kernel, params, args, misaligned):
    ta = analyze_tiling(kernel, params, args, {"state_dim": 16})
    assert ta.misaligned == misaligned
    assert ta.is_aligned == (not misaligned)
    assert ta.refused is None


def test_refusals_are_the_wrappers():
    """bf16 flash block_q over 256, the SSD's wide route over chunk 128, a
    bf16 head_dim without an instance: refused, with check_launch's words."""
    q = _meta(1, 1024, 4, 64)
    ta = analyze_tiling("flash_attention", {"block_q": 512, "block_k": 64},
                        (q,))
    assert ta.is_aligned and not ta.admissible
    assert ta.refused == fa_mod.check_launch(
        {"block_q": 512, "block_k": 64}, (q.shape, q.shape), BF16)
    assert "block_q <= 256" in ta.refused
    x, b = _meta(1, 2048, 4, 384), _meta(1, 2048, 4, 384)
    ta = analyze_tiling("ssd_scan", {"chunk": 256}, (x, _meta(1, 2048, 4),
                                                     b, b))
    assert "chunk <= 128 with P and N <= 384" in ta.refused
    assert analyze_tiling("ssd_scan", {"chunk": 128},
                          (x, _meta(1, 2048, 4), b, b)).admissible
    ta = analyze_tiling("flash_attention", {"block_q": 64, "block_k": 64},
                        (_meta(1, 256, 4, 72),))
    assert "head_dim a multiple of 16" in ta.refused


@pytest.mark.parametrize("chunk", [16, 32, 64, 128])
def test_ssd_wide_route_admits_each_chunk_at_one_footprint(chunk):
    """At the mLSTM's widths every chunk up to 128 is aligned and
    admissible, and its shared memory is the same: the wide passes' boxes
    hold 128 steps whatever the chunk (216,064 B)."""
    x, b = _meta(1, 2048, 4, 384), _meta(1, 2048, 4, 384)
    ta = analyze_tiling("ssd_scan", {"chunk": chunk},
                        (x, _meta(1, 2048, 4), b, b))
    assert ta.is_aligned and ta.admissible
    assert ssd_mod.smem_bytes({"chunk": chunk}, (x.shape, b.shape),
                              BF16) == 216064
    assert ssd_mod.check_launch({"chunk": chunk}, (x.shape, b.shape), BF16,
                                216064) is None
    assert "216064 B of shared memory" in ssd_mod.check_launch(
        {"chunk": chunk}, (x.shape, b.shape), BF16, 216063)


def test_lint_tiling_scn204_to_207():
    x = (_meta(1, 200, 4, 72),)       # 72 has no bf16 instance: refused
    kept, flagged, diags = lint_tiling(
        "flash_attention", [{"block_q": 64, "block_k": 64},
                            {"block_q": 48, "block_k": 64}], x,
        subject="flash")
    assert kept == [] and len(flagged) == 2
    assert _codes(diags) == [("SCN204", INFO), ("SCN205", INFO),
                             ("SCN207", INFO), ("SCN204", WARNING),
                             ("SCN205", INFO), ("SCN206", ERROR)]
    assert "no bf16 instance" in diags[2].message
    assert all(d.subject == "flash" for d in diags)

    x = (_meta(1, 600, 4, 64),)
    cands = [{"block_q": 64, "block_k": 64}, {"block_q": 48, "block_k": 64},
             {"block_q": 512, "block_k": 64}]
    kept, flagged, diags = lint_tiling("flash_attention", cands, x)
    assert kept == [cands[0]]
    assert set(flagged) == {json.dumps(p, sort_keys=True) for p in cands[1:]}
    # 600 rows in 64-row tiles: 640 launched, 6% padding
    assert _codes(diags) == [("SCN205", INFO), ("SCN204", WARNING),
                             ("SCN205", INFO), ("SCN204", INFO),
                             ("SCN205", INFO)]
    ta = analyze_tiling("flash_attention", cands[0], x)
    assert math.isclose(ta.waste_fraction, 1 - 600 / 640)
    assert ta.waste_fraction > WASTE_THRESHOLD
    assert misaligned_candidates("flash_attention", cands, x) == flagged

    # fp32 rows of 6 floats: not whole 16-byte pieces, and refused
    q = _meta(1, 6, dtype=F32).expand(2, 8, 6)
    k = _meta(2, 256, 2, 6, dtype=F32)
    kept, flagged, diags = lint_tiling(
        "decode_attention", [{"block_k": 128}], (q, k, k, None))
    assert ("SCN207", INFO) in _codes(diags)
    assert "24 B, not whole 16-byte pieces" in next(
        d.message for d in diags if d.code == "SCN207")
    assert _codes(diags)[-1] == ("SCN206", ERROR)


def test_aligned_sweeps_and_unknown_kernels_say_nothing():
    x = (_meta(1, 4096, 32, 80),)
    for kernel, cands in [("flash_attention",
                           [{"block_q": 64, "block_k": 64},
                            {"block_q": 128, "block_k": 256}]),
                          ("ssd_scan", [{"chunk": 32}, {"chunk": 256}])]:
        assert lint_tiling(kernel, cands, x,
                           options={"state_dim": 64}) == (cands, {}, [])
    assert lint_tiling("mystery", [{"x": 3}], x) == ([{"x": 3}], {}, [])
    assert misaligned_candidates("mystery", [{"x": 3}], x) == {}
    assert analyze_tiling("decode_attention", {"block_k": 64},
                          (_meta(2, 8, 64),)) is None   # no cache dims


H100 = H100_SMEM_PER_BLOCK


class _Launched(Exception):
    """Raised by the stubbed library: the wrapper's checks passed."""


def _refusal(fn, *args):
    with pytest.raises((ValueError, _Launched)) as exc:
        fn(*args)
    return str(exc.value) if exc.type is ValueError else None


@pytest.mark.parametrize("case", [
    "flash_hd72", "flash_block_q", "flash_smem", "flash_ok",
    "decode_hd96", "decode_fp32_hd6", "decode_smem", "decode_ok",
    "ssd_wide_chunk", "ssd_fp32_smem", "ssd_ok"])
def test_check_launch_gives_the_reason_launch_raises(monkeypatch, case):
    """``_launch`` on CPU tensors, with the library stubbed to raise after
    the checks: it raises exactly check_launch's reason, or gets past the
    checks where check_launch says None."""
    def library(name):
        raise _Launched(name)
    monkeypatch.setattr(_build, "library", library)
    for mod in (fa_mod, da_mod, ssd_mod):
        monkeypatch.setattr(mod, "card_smem_limit", lambda d: H100)
    kernel, _, what = case.partition("_")
    what = what.split("_")[0]
    if kernel == "flash":
        hd, bq, bk = {"hd72": (72, 64, 64), "block": (64, 512, 64),
                      "smem": (256, 128, 128), "ok": (80, 64, 64)}[what]
        q = torch.zeros(1, 1024, 2, hd, dtype=BF16)
        want = fa_mod.check_launch({"block_q": bq, "block_k": bk},
                                   (q.shape, q.shape), BF16, H100)
        got = _refusal(fa_mod._launch, q, q, q, True, None, None, bq, bk)
    elif kernel == "decode":
        hd, dtype, bk = {"hd96": (96, BF16, 64), "fp32": (6, F32, 64),
                         "smem": (256, BF16, 512), "ok": (64, F32, 64)}[what]
        q = torch.zeros(2, 4, hd, dtype=dtype)
        k = torch.zeros(2, 1024, 2, hd, dtype=dtype)
        lengths = torch.full((2,), 1024, dtype=torch.int32)
        want = da_mod.check_launch({"block_k": bk}, (q.shape, k.shape), dtype,
                                   H100)
        if what == "ok":       # past the checks, split_plan asks the card
            monkeypatch.setattr(da_mod, "split_plan",
                                lambda *a: library("decode_attention"))
        got = _refusal(da_mod._launch, q, k, k, lengths, None, None, bk)
    else:
        P, N, dtype, chunk = {"wide": (384, 384, BF16, 256),
                              "fp32": (80, 64, F32, 256),
                              "ok": (80, 64, BF16, 128)}[what]
        x = torch.zeros(1, 512, 2, P, dtype=dtype)
        b = torch.zeros(1, 512, 2, N, dtype=dtype)
        la = torch.zeros(1, 512, 2)
        want = ssd_mod.check_launch({"chunk": chunk}, (x.shape, b.shape),
                                    dtype, H100)
        got = _refusal(ssd_mod._launch, x, la, b, b, chunk)
    assert got == want
    assert (want is None) == (what == "ok")


def _tuner(candidates, tile_check=True):
    seen = []

    def factory(params):
        def fn(x):
            return x
        fn.params = dict(params)
        return fn

    def measure(fn, args):
        seen.append(dict(fn.params))
        return float(sum(fn.params.values()))

    tuner = KernelAutotuner(candidates={"flash_attention": candidates},
                            measure=measure, tile_check=tile_check,
                            device="meta")
    return tuner, factory, seen


X = (_meta(1, 1024, 2, 64),)


def test_tile_check_prunes_before_measuring():
    cands = [{"block_q": 128, "block_k": 128}, {"block_q": 48, "block_k": 64},
             {"block_q": 512, "block_k": 64}]
    tuner, factory, seen = _tuner(cands)
    rec = tuner.tune("flash_attention", factory, X)
    assert seen == [cands[0]]
    assert set(rec.tile_pruned) == {json.dumps(p, sort_keys=True)
                                    for p in cands[1:]}
    assert "misaligned" in rec.tile_pruned['{"block_k": 64, "block_q": 48}']
    assert "refused" in rec.tile_pruned['{"block_k": 64, "block_q": 512}']
    assert rec.params == cands[0]

    tuner, factory, seen = _tuner(cands, tile_check=False)
    rec = tuner.tune("flash_attention", factory, X)
    assert rec.tile_pruned == {} and len(seen) == 3


def test_tile_check_never_empties_a_sweep():
    cands = [{"block_q": 48, "block_k": 100}]
    tuner, factory, seen = _tuner(cands)
    rec = tuner.tune("flash_attention", factory, X, defaults=cands[0])
    assert rec.params == cands[0] and rec.tile_pruned == {}
    assert seen == cands


def test_tune_record_json_round_trips_tile_pruned():
    tuner, factory, _ = _tuner([{"block_q": 128, "block_k": 128},
                                {"block_q": 48, "block_k": 64}])
    rec = tuner.tune("flash_attention", factory, X)
    back = KernelAutotuner.from_json(tuner.to_json(), device="meta")
    got = next(iter(back.records.values()))
    assert got.tile_pruned == rec.tile_pruned and len(got.tile_pruned) == 1
    # records written before tile_pruned existed still load
    payload = json.loads(tuner.to_json())
    for r in payload:
        r.pop("tile_pruned")
    back = KernelAutotuner.from_json(json.dumps(payload), device="meta")
    assert next(iter(back.records.values())).tile_pruned == {}


@pytest.fixture
def clean():
    clear_tuned_params()
    yield
    clear_tuned_params()


def _db(*tuned):
    db = BenchmarkDB(model="lm", n_blocks=len(tuned))
    db.records["cloud"] = [
        BlockBenchmark(block=i, resource="cloud", mean_time_s=1e-3,
                       std_time_s=0.0, output_bytes=64, runs=1,
                       tuned_params=t) for i, t in enumerate(tuned)]
    return db


@pytest.mark.parametrize("dtype,flash,adopted", [
    ("bfloat16", {"block_q": 48, "block_k": 64}, False),
    ("bfloat16", {"block_q": 64, "block_k": 64}, True),
    ("bfloat16", {"block_q": 64, "block_k": 96}, False),
    ("float32", {"block_q": 48, "block_k": 100}, True),
    ("float32", {"block_q": 0, "block_k": 64}, False),
])
def test_adoption_rejects_what_the_hopper_route_pads(clean, dtype, flash,
                                                     adopted):
    """bf16 flash block_q 48 runs a padded 64-row tile: rejected, 64
    adopted; the fp32 route cuts tiles to the sequence and takes any
    positive size."""
    got = adopt_tuned_params(_db({"attn": flash}), dtype=dtype)
    assert ("flash_attention" in got) == adopted
    assert serving_param("flash_attention", "block_q", 512) == \
        (flash["block_q"] if adopted else 512)


def test_adoption_by_kernel_in_bf16(clean):
    got = adopt_tuned_params(_db({"dec": {"block_k": 100}},
                                 {"ssd": {"chunk": 40}}), dtype="bfloat16")
    assert got == {}
    got = adopt_tuned_params(_db({"dec": {"block_k": 128}},
                                 {"ssd": {"chunk": 48}}), dtype=BF16)
    assert got == {"decode_attention": {"block_k": 128},
                   "ssd_scan": {"chunk": 48}}
    assert misaligned_params("ssd_scan", {"chunk": 40}, BF16) == \
        {"chunk": (40, 16)}
