"""The port's shared-memory analysis (``repro_torch.analysis.kernel_smem``,
SCN201-203) on the CPU.

A footprint is each kernel's own ``smem_bytes`` after its tile rounding, so
the analysis is held against the wrappers' figure and against values worked
out by hand from the ``csrc/*.cu`` layouts, route by route.  At an H100's
limit (232,448 B a block) the analysis prunes what the wrappers' halving
avoids: bf16 flash at head_dim 256 loses 128 x 128 and keeps 128 x 64.  The
autotuner's prune goes through the analysis and keeps today's records.
"""

import json

import pytest
import torch

from repro_torch.analysis.diagnostics import ERROR, INFO
from repro_torch.analysis.kernel_smem import (H100_SMEM_PER_BLOCK,
                                              kernel_footprint,
                                              kernel_shapes,
                                              kernel_smem_bytes,
                                              known_kernels, lint_candidates)
from repro_torch.core import TensorSpec
from repro_torch.kernels import (DEFAULT_CANDIDATES, KernelAutotuner,
                                 decode_attention_node, flash_attention_node,
                                 ssd_scan_node)
from repro_torch.kernels import decode_attention as da_mod
from repro_torch.kernels import flash_attention as fa_mod
from repro_torch.kernels import ssd_scan as ssd_mod

BF16, F32 = torch.bfloat16, torch.float32
MODS = {"flash_attention": fa_mod, "decode_attention": da_mod,
        "ssd_scan": ssd_mod}


def _meta(*shape, dtype=BF16):
    return torch.empty(shape, dtype=dtype, device="meta")


def _args(kernel, dtype, hd=80, S=512):
    """The kernel's own positional arguments on meta."""
    if kernel == "flash_attention":
        q, k = _meta(1, S, 8, hd, dtype=dtype), _meta(1, S + 64, 2, hd,
                                                      dtype=dtype)
        return q, k, k
    if kernel == "decode_attention":
        k = _meta(2, S, 2, hd, dtype=dtype)
        return _meta(2, 8, hd, dtype=dtype), k, k, _meta(2, dtype=torch.int32)
    b = _meta(1, S, 4, 64, dtype=dtype)
    return _meta(1, S, 4, hd, dtype=dtype), _meta(1, S, 4), b, b


def test_known_kernels():
    assert known_kernels() == ("decode_attention", "flash_attention",
                               "ssd_scan")


@pytest.mark.parametrize("kernel", sorted(DEFAULT_CANDIDATES))
@pytest.mark.parametrize("dtype", [F32, BF16])
def test_footprints_equal_the_wrappers_smem_bytes(kernel, dtype):
    """Every default candidate, with the kernel's own arguments and with a
    graph node's single input: the analysis is the wrapper's figure, and
    its parts sum to it."""
    hd = 64 if kernel == "decode_attention" and dtype == F32 else 80
    if kernel == "decode_attention" and dtype == BF16:
        hd = 128
    args = _args(kernel, dtype, hd)
    shapes = kernel_shapes(kernel, args)
    for params in DEFAULT_CANDIDATES[kernel]:
        fp = kernel_footprint(kernel, params, args)
        want = MODS[kernel].smem_bytes(params, shapes, dtype)
        assert fp.smem_bytes == sum(fp.parts.values()) == want
        assert fp.dtype == str(dtype).removeprefix("torch.")
    # a node's single input: k = q; the decode node's cache; b = c = N wide
    x = args[0]
    shapes = {"flash_attention": (x.shape, x.shape),
              "decode_attention": (x.shape, (2, 512, 2, hd)),
              "ssd_scan": (x.shape, (*x.shape[:-1], 64))}[kernel]
    for params in DEFAULT_CANDIDATES[kernel]:
        assert kernel_smem_bytes(kernel, params, (x,), {
            "cache_len": 512, "kv_heads": 2, "state_dim": 64}) == \
            MODS[kernel].smem_bytes(params, shapes, dtype)


@pytest.mark.parametrize("kernel,params,args,parts", [
    # flash bf16 (fa_mma_smem_bytes): the q tile and two stages of k and v,
    # rows padded to hd + 8 = 88 bf16
    ("flash_attention", {"block_q": 64, "block_k": 64},
     (_meta(1, 512, 4, 80),), {"q": 2 * 88 * 64, "k": 2 * 88 * 128,
                               "v": 2 * 88 * 128}),
    # block_q 48 runs a 64-row tile, block_k 100 a 128-row one
    ("flash_attention", {"block_q": 48, "block_k": 100},
     (_meta(1, 512, 4, 80),), {"q": 2 * 88 * 64, "k": 2 * 88 * 256,
                               "v": 2 * 88 * 256}),
    # flash fp32 (fa_smem_floats): q, k padded to an odd stride, v, scores,
    # the accumulator, three softmax rows
    ("flash_attention", {"block_q": 64, "block_k": 32},
     (_meta(1, 512, 4, 64, dtype=F32),),
     {"q": 4 * 64 * 64, "k": 4 * 32 * 65, "v": 4 * 32 * 64,
      "scores": 4 * 64 * 32, "acc": 4 * 64 * 64, "softmax": 4 * 3 * 64}),
    # decode bf16 (da_mma_smem): a 16-row q tile and a ring of
    # max(3, 256 / 64 + 1) = 5 stages of 64-row k and v tiles
    ("decode_attention", {"block_k": 256},
     _args("decode_attention", BF16, 128, 4096),
     {"q": 2 * 136 * 16, "k": 2 * 136 * 64 * 5, "v": 2 * 136 * 64 * 5}),
    # decode fp32 (da_layout), G = 4: 16-byte aligned k, v tiles, scores,
    # q group, reduction slots, 4 row groups of accumulators
    ("decode_attention", {"block_k": 128},
     _args("decode_attention", F32, 64, 4096),
     {"k": 128 * 64 * 4, "v": 128 * 64 * 4, "scores": 128 * 4 * 4,
      "q": 4 * 64 * 4, "reduction": 2 * 8 * 4 * 4, "acc": 4 * 4 * 64 * 4}),
    # SSD bf16 narrow (chunked_smem), P 80 -> 88, N 64 -> 72 padded rows:
    # the scan pass binds (x, S_in high and low, seg and exp(seg), b, c)
    ("ssd_scan", {"chunk": 64}, _args("ssd_scan", BF16, 80),
     {"scan x": 2 * 64 * 88, "scan S_in": 4 * 64 * 88, "scan seg": 8 * 64,
      "scan b": 2 * 64 * 72, "scan c": 2 * 64 * 72}),
    # the wide route (P = N = 384), boxes of 128 steps by 128 bytes (16 KB),
    # S_in and (b w)^T boxes of 64 rows (8 KB): ssd_wide_state's terms (the
    # scan pass takes as many bytes), three stages of b's box and two of
    # x's two boxes, two (b w)^T buffers of four boxes, S_in's high and low
    # parts of two boxes each on their way out, 2 KB of barriers and
    # weights, 1 KB of alignment
    ("ssd_scan", {"chunk": 128},
     (_meta(1, 2048, 4, 384), _meta(1, 2048, 4), _meta(1, 2048, 4, 384),
      _meta(1, 2048, 4, 384)),
     {"state b": 3 * 16384, "state x": 2 * 2 * 16384,
      "state (b w)^T, high and low, twice": 2 * 4 * 8192,
      "state S_in out, high and low": 2 * 2 * 8192,
      "state barriers, weights": 2048,
      "state alignment": 1024}),
    # ... whatever the chunk: a box holds 128 steps
    ("ssd_scan", {"chunk": 32},
     (_meta(1, 2048, 4, 384), _meta(1, 2048, 4), _meta(1, 2048, 4, 384),
      _meta(1, 2048, 4, 384)),
     {"state b": 3 * 16384, "state x": 2 * 2 * 16384,
      "state (b w)^T, high and low, twice": 2 * 4 * 8192,
      "state S_in out, high and low": 2 * 2 * 8192,
      "state barriers, weights": 2048,
      "state alignment": 1024}),
    # ... and whatever the widths (wide by P alone, N = 32)
    ("ssd_scan", {"chunk": 32},
     (_meta(1, 100, 2, 160), _meta(1, 100, 2), _meta(1, 100, 2, 32),
      _meta(1, 100, 2, 32)),
     {"state b": 3 * 16384, "state x": 2 * 2 * 16384,
      "state (b w)^T, high and low, twice": 2 * 4 * 8192,
      "state S_in out, high and low": 2 * 2 * 8192,
      "state barriers, weights": 2048,
      "state alignment": 1024}),
    # SSD fp32 (ssd_smem_floats): x, b and c rows padded, scores, state,
    # three seg rows
    ("ssd_scan", {"chunk": 32},
     (_meta(1, 64, 1, 16, dtype=F32), _meta(1, 64, 1, dtype=F32),
      _meta(1, 64, 1, 8, dtype=F32), _meta(1, 64, 1, 8, dtype=F32)),
     {"x": 4 * 32 * 16, "b, c": 4 * 2 * 32 * 9, "scores": 4 * 32 * 32,
      "state": 4 * 8 * 16, "seg": 4 * 3 * 32}),
])
def test_footprints_worked_out_from_the_cu_layouts(kernel, params, args,
                                                   parts):
    fp = kernel_footprint(kernel, params, args, {"state_dim": 64})
    assert fp.parts == parts
    assert fp.smem_bytes == sum(parts.values())


def test_lint_candidates_splits_at_the_limit():
    x = (_meta(1, 4096, 16, 256),)
    cands = DEFAULT_CANDIDATES["flash_attention"]
    kept, pruned, diags = lint_candidates("flash_attention", cands, x,
                                          H100_SMEM_PER_BLOCK,
                                          subject="flash")
    sizes = {json.dumps(p, sort_keys=True):
             kernel_smem_bytes("flash_attention", p, x) for p in cands}
    assert kept == [p for p in cands
                    if sizes[json.dumps(p, sort_keys=True)]
                    <= H100_SMEM_PER_BLOCK]
    assert pruned == {k: v for k, v in sizes.items()
                      if v > H100_SMEM_PER_BLOCK}
    assert [d.code for d in diags] == ["SCN201"] * len(pruned)
    assert all(d.severity == INFO and d.subject == "flash" for d in diags)

    # no limit: everything kept, nothing said
    assert lint_candidates("flash_attention", cands, x, None) == \
        (cands, {}, [])
    # all pruned: SCN202 names the smallest footprint
    kept, pruned, diags = lint_candidates("flash_attention", cands, x, 1000)
    assert kept == [] and len(pruned) == len(cands)
    d = diags[-1]
    assert d.code == "SCN202" and d.severity == ERROR
    assert f"smallest needs {min(pruned.values())} B" in d.message
    # an unknown kernel is kept unchecked
    kept, pruned, diags = lint_candidates("mystery", [{"x": 1}], x, 1000)
    assert kept == [{"x": 1}] and not pruned
    assert [(d.code, d.severity) for d in diags] == [("SCN203", INFO)]
    assert kernel_footprint("mystery", {}, x) is None


def test_h100_limit_prunes_what_block_sizes_halves(monkeypatch):
    """bf16 flash at head_dim 256 (gemma2-9b): 128 x 128 needs 337,920 B,
    pruned; 128 x 64 needs 202,752 B, kept: the size ``block_sizes``
    halves the default to on the card."""
    q, k = _meta(1, 4096, 16, 256), _meta(1, 4096, 8, 256)
    kept, pruned, _ = lint_candidates(
        "flash_attention", DEFAULT_CANDIDATES["flash_attention"], (q, k, k),
        H100_SMEM_PER_BLOCK)
    assert pruned['{"block_k": 128, "block_q": 128}'] == 337920
    assert {"block_q": 128, "block_k": 64} in kept
    assert kept == [{"block_q": 64, "block_k": 64},
                    {"block_q": 128, "block_k": 64}]
    monkeypatch.setattr(fa_mod, "card_smem_limit",
                        lambda d: H100_SMEM_PER_BLOCK)
    assert fa_mod.block_sizes(q, k) == (128, 64)


def _old_prune(kernel, x, options, limit):
    """The autotuner's prune before it went through the analysis: each
    candidate whose footprint at the node's shapes (then
    ``ops.smem_footprint``) is over the limit."""
    k = {"flash_attention": x,
         "decode_attention": (x[0], options.get("cache_len"),
                              options.get("kv_heads"), x[2]),
         "ssd_scan": (*x[:-1], options.get("state_dim", 16))}[kernel]
    return {json.dumps(p, sort_keys=True): float(n)
            for p in DEFAULT_CANDIDATES[kernel]
            if (n := MODS[kernel].smem_bytes(p, (x, k), BF16)) > limit}


@pytest.mark.parametrize("tile_check", [False, True])
def test_autotuner_records_are_todays_for_the_default_grids(tile_check):
    """At the main paths' widths (prefill at zamba2-2.7b's, decode at
    granite-8b's, bf16) the default grids hold no misaligned or refused
    candidate: the records are the same with ``tile_check`` on or off,
    their ``pruned`` is the old rule's, and the winners the timings pick."""
    def measure(fn, args):
        return fn.cost

    def timed(node):
        real = node.kernel_factory

        def factory(p):
            fn = real(p)
            # a made-up time per candidate: 1 + a hash of its sizes
            fn_cost = 1.0 + (sum(v * (i + 3) for i, v in
                                 enumerate(sorted(p.values()))) % 97) / 97
            wrapped = lambda *a: fn(*a)             # noqa: E731
            wrapped.cost = fn_cost
            return wrapped
        node.kernel_factory = factory
        return node

    cases = [
        (flash_attention_node("a", device="cpu"),
         TensorSpec((1, 4096, 32, 80), BF16)),
        (ssd_scan_node("s", state_dim=64, device="cpu"),
         TensorSpec((1, 4096, 32, 80), BF16)),
        (decode_attention_node("d", cache_len=4096, kv_heads=8, head_dim=128,
                               batch=16, device="cpu",
                               cache=(_meta(16, 4096, 8, 128),) * 2),
         TensorSpec((16, 32, 128), BF16)),
        (flash_attention_node("g", device="cpu"),
         TensorSpec((1, 4096, 16, 256), BF16)),
    ]
    records = []
    for node, spec in cases:
        tuner = KernelAutotuner(measure=measure, smem_limit=H100_SMEM_PER_BLOCK,
                                device="meta", tile_check=tile_check)
        rec = tuner.tune_node(timed(node), resource="cloud", in_specs=[spec])
        assert rec.pruned == _old_prune(node.kernel, spec.shape,
                                        node.kernel_options,
                                        H100_SMEM_PER_BLOCK)
        assert rec.tile_pruned == {}
        assert len(rec.trials) + len(rec.pruned) == \
            len(DEFAULT_CANDIDATES[node.kernel])
        records.append(json.loads(tuner.to_json()))
    other = []
    for node, spec in cases:
        tuner = KernelAutotuner(measure=measure, smem_limit=H100_SMEM_PER_BLOCK,
                                device="meta", tile_check=not tile_check)
        tuner.tune_node(timed(node), resource="cloud", in_specs=[spec])
        other.append(json.loads(tuner.to_json()))
    assert records == other
