"""The port's dry-run: per-device counts on ``meta`` DTensors over a fake
process group, its record read by the reference's roofline, and its CLI
on a full config.

Each count is checked by hand or against an unsharded count: the FLOPs of
a matrix product's local shard (the DTensor-level call and DTensor's
global shape inference must not add theirs), a 1 x 1 mesh's train step
against ``FlopCounterMode`` over the unsharded step, the bytes of known
redistributions by kind and of the split-KV combine's two collectives.  Costs at 2, 3 and 4 groups of a reduced config
lie on a line that the whole depth's count meets: the eager trace runs
every layer, so the reference's two-point extrapolation has nothing to
recover.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
import torch.distributed as dist

from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.steps import make_train_step
from repro_torch.models import build_model, get_config

ROOT = Path(__file__).resolve().parents[1]
# the reference's record keys (src/repro/launch/dryrun.py:188-206)
REF_KEYS = {"arch", "shape", "mesh", "status", "lower_s", "compile_s",
            "n_devices", "hlo_flops_per_device", "hlo_bytes_per_device",
            "collective_bytes_per_device", "collectives",
            "collectives_scan_body_once", "memory", "model_flops_total"}
MEMORY_KEYS = {"argument_bytes", "output_bytes", "temp_bytes", "alias_bytes"}


@pytest.fixture(scope="module")
def world():
    """The 512-rank fake group; destroyed after the module."""
    make_production_mesh()
    yield
    dist.destroy_process_group()


def _mesh(shape, names=("data", "model")):
    from torch.distributed.device_mesh import DeviceMesh
    n = 1
    for s in shape:
        n *= s
    return DeviceMesh("cpu", torch.arange(n).reshape(shape),
                      mesh_dim_names=names)


def _meta_dtensor(shape, mesh, placements, dtype=torch.float32):
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(torch.empty(shape, dtype=dtype, device="meta"),
                             mesh, list(placements))


def test_matmul_flops_are_the_local_shards(world):
    """(64, 128) rows over data times (128, 256) columns over model on a
    2 x 4 mesh: 2·32·128·64 FLOPs on each rank, not the global
    2·64·128·256 nor the sum of both."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = _mesh((2, 4))
    a = _meta_dtensor((64, 128), mesh, [Shard(0), Replicate()])
    b = _meta_dtensor((128, 256), mesh, [Replicate(), Shard(1)])
    costs = dryrun.trace_costs(lambda x, y: x @ y, (a, b))
    assert costs["flops"] == 2 * 32 * 128 * 64
    # bytes: the local operands and result, once
    assert costs["bytes"] == 4 * (32 * 128 + 128 * 64 + 32 * 64)
    assert costs["collectives"]["total"] == 0
    assert costs["memory"]["argument_bytes"] == 4 * (32 * 128 + 128 * 64)
    assert costs["memory"]["output_bytes"] == 4 * 32 * 64


def test_collectives_by_kind(world):
    """Known redistributions of a (32, 64) fp32 tensor on a 2 x 4 mesh,
    each sized by its output; a wait is no second collective, and a shard
    moving to another dimension is one all-to-all."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = _mesh((2, 4))
    x = _meta_dtensor((32, 64), mesh, [Shard(0), Replicate()])
    p = _meta_dtensor((32, 64), mesh, [Replicate(), Replicate()])
    p = p.redistribute(mesh, [Replicate(), Replicate()])

    def partial(t):
        from torch.distributed.tensor import DTensor
        return DTensor.from_local(t.to_local(), mesh,
                                  [Replicate(), Partial()], run_check=False)

    cases = [
        (lambda: x.redistribute(mesh, [Replicate(), Replicate()]),
         "all-gather", 4 * 32 * 64),
        (lambda: partial(p).redistribute(mesh, [Replicate(), Replicate()]),
         "all-reduce", 4 * 32 * 64),
        (lambda: partial(p).redistribute(mesh, [Replicate(), Shard(0)]),
         "reduce-scatter", 4 * 8 * 64),
        (lambda: x.redistribute(mesh, [Shard(1), Replicate()]),
         "all-to-all", 4 * 32 * 32),
    ]
    for fn, kind, nbytes in cases:
        got = dryrun.trace_costs(lambda: fn(), ())["collectives"]
        assert got[kind] == nbytes, (kind, got)
        assert got["total"] == nbytes, (kind, got)

    def gather_and_wait():
        """A functional all-gather over the model axis and its explicit
        wait: one collective."""
        t = torch.empty(8, 64, device="meta")
        group = mesh.get_group(1).group_name
        out = torch.ops._c10d_functional.all_gather_into_tensor(t, 4, group)
        return torch.ops._c10d_functional.wait_tensor(out)

    got = dryrun.trace_costs(gather_and_wait, ())["collectives"]
    assert got["all-gather"] == got["total"] == 4 * 32 * 64


@pytest.mark.parametrize("split", [("model",), ("data", "model")])
def test_split_kv_combine_counts_its_collectives(world, split):
    """decode_attention over a (4, 64, 2, 16) fp32 cache split on its
    sequence over ``split`` of a 2 x 4 mesh, q (4, 8, 16) replicated: per
    rank one all-gather of the (4, 8) log-sum-exp a splitting dimension
    (sized by its output) and one all-reduce of (4, 8, 17) weighted
    outputs and weights a splitting dimension, and nothing else."""
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.kernels.decode_attention import decode_attention
    mesh = _mesh((2, 4))
    pl = [Shard(1) if n in split else Replicate() for n in ("data", "model")]
    q = _meta_dtensor((4, 8, 16), mesh, [Replicate(), Replicate()])
    k = _meta_dtensor((4, 64, 2, 16), mesh, pl)
    lengths = torch.full((4,), 40, dtype=torch.int32, device="meta")
    got = dryrun.trace_costs(
        lambda a, b: decode_attention(a, b, b, lengths, window=20),
        (q, k))["collectives"]
    sizes = [mesh.size(mesh.mesh_dim_names.index(n)) for n in split]
    assert got["all-gather"] == sum(4 * r * 4 * 8 for r in sizes), got
    assert got["all-reduce"] == len(split) * 4 * 4 * 8 * 17, got
    assert got["total"] == got["all-gather"] + got["all-reduce"], got


def _granite_small(**kw):
    small = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                 head_dim=16, d_ff=128, vocab=256, remat=False,
                 loss_seq_chunk=None)
    return get_config("granite-8b").replace(**{**small, **kw})


def _zamba_small(groups: int):
    return get_config("zamba2-2.7b").replace(
        n_layers=2 * groups, shared_attn_period=2, d_model=64, n_heads=4,
        n_kv_heads=4, head_dim=16, d_ff=128, vocab=256, ssm_state=16,
        ssm_head_dim=16, ssm_chunk=16, loss_seq_chunk=16)


def test_one_by_one_mesh_counts_the_unsharded_steps_flops(world):
    """On a 1 x 1 mesh every rank holds everything: the train step's FLOPs
    equal ``FlopCounterMode`` over the unsharded step on ``meta``."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.models import layers as L
    from repro_torch.optim import AdamWConfig, init_state
    cfg = _zamba_small(2)
    shape = ShapeConfig("t", 32, 4, "train")
    step, args = dryrun.build_step_and_args("zamba2-2.7b", shape,
                                            _mesh((1, 1)), False, cfg=cfg)
    got = dryrun.trace_costs(step, args)["flops"]
    model = build_model(cfg, device="meta")
    params = L.tree_map(lambda p: torch.empty(p.shape, dtype=torch.bfloat16,
                                              device="meta"), model.spec())
    batch = {k: torch.zeros((4, 32), dtype=torch.int32, device="meta")
             for k in ("tokens", "labels")}
    with FlopCounterMode(display=False) as fc:
        make_train_step(model, AdamWConfig())(params, init_state(params),
                                              batch)
    assert got == fc.get_total_flops() > 0


def test_costs_follow_depth_as_the_trace_runs_it(world):
    """A reduced zamba2's per-device costs at 2, 3 and 4 groups, and at 6:
    FLOPs and collective bytes lie on a line that the count at 6 meets.
    The bytes do not: each group's parameters are views of the stacked
    (G, ...) leaves, and each view's backward writes a whole (G, ...)
    gradient that autograd sums, so the bytes grow as G².  A two-point
    extrapolation would miss that term; the trace, which runs every group,
    counts it (the three points fix the parabola that the count at 6
    meets)."""
    shape = ShapeConfig("t", 32, 4, "train")
    mesh = _mesh((2, 2))

    def costs(g):
        step, args = dryrun.build_step_and_args(
            "zamba2-2.7b", shape, mesh, False, cfg=_zamba_small(g))
        c = dryrun.trace_costs(step, args)
        return c["flops"], c["collectives"]["total"], c["bytes"]

    c2, c3, c4, c6 = (costs(g) for g in (2, 3, 4, 6))
    for a, b, c, d in list(zip(c2, c3, c4, c6))[:2]:
        assert b - a == c - b > 0
        assert d == a + 4 * (b - a)
    a, b, c, d = c2[2], c3[2], c4[2], c6[2]
    curve = (c - b) - (b - a)
    assert curve > 0
    assert d == a + 4 * (b - a) + 6 * curve
    assert d > a + 4 * (b - a)


def test_record_has_the_reference_keys_and_reads_in_its_roofline(world):
    from repro.launch import roofline as ref_roofline
    from repro_torch.launch import roofline
    rec = dryrun.run_cell("granite-8b", ShapeConfig("decode_t", 64, 32,
                                                    "decode"),
                          multi_pod=False, verbose=False,
                          cfg=_granite_small(n_heads=32, n_kv_heads=8))
    assert rec["status"] == "OK", rec.get("trace")
    assert set(rec) == REF_KEYS
    assert set(rec["memory"]) == MEMORY_KEYS
    assert rec["n_devices"] == 256
    assert rec["hlo_flops_per_device"] > 0
    assert rec["hlo_bytes_per_device"] > 0
    assert rec["memory"]["argument_bytes"] > 0
    assert rec["collectives"]["total"] == rec["collective_bytes_per_device"]
    a, b = ref_roofline.analyse(rec), roofline.analyse(rec)
    assert a["useful_flops_ratio"] == b["useful_flops_ratio"] > 0
    assert json.loads(json.dumps(rec)) == rec


def test_cell_skipped_and_failed_records(world):
    from repro_torch.configs.base import LONG_500K
    rec = dryrun.run_cell("granite-8b", LONG_500K, multi_pod=False,
                          verbose=False)
    assert rec["status"] == "SKIP" and "quadratic" in rec["reason"]
    assert dryrun.cell_skipped("zamba2-2.7b", LONG_500K) is None
    assert dryrun.ARCHS == __import__(
        "repro.launch.dryrun", fromlist=["ARCHS"]).ARCHS
    # 3 groups of the SSD's B and C do not divide its 8 heads: the cell
    # fails (the SSD takes a sequence of any length, so a ragged one no
    # longer does)
    rec = dryrun.run_cell("zamba2-2.7b", ShapeConfig("t", 32, 16, "train"),
                          multi_pod=False, verbose=False,
                          cfg=_zamba_small(2).replace(ssm_groups=3))
    assert rec["status"] == "FAIL" and "ValueError" in rec["error"]
    assert "trace" in rec


def _reduced(arch):
    """``arch`` at a few layers and narrow widths, its kinds of layer kept;
    16 ranks take its heads, so the mesh splits them."""
    cfg = get_config(arch)
    kw = dict(d_model=64, n_heads=16, n_kv_heads=4, head_dim=16, d_ff=128,
              vocab=256, ssm_state=16, ssm_head_dim=16, ssm_chunk=16,
              window=16, loss_seq_chunk=None,
              n_layers=(cfg.shared_attn_period or len(cfg.pattern)) * 2)
    if cfg.n_kv_heads == cfg.n_heads:
        kw["n_kv_heads"] = 16
    if cfg.is_encdec:
        kw.update(encoder_layers=2, encoder_len=32)
    if cfg.n_img_tokens:
        kw.update(n_img_tokens=8)
    if cfg.moe_experts:
        kw.update(moe_group_size=64)
    if cfg.query_pre_attn_scalar:
        kw.update(query_pre_attn_scalar=16.0)
    return cfg.replace(**kw)


@pytest.mark.parametrize("arch", dryrun.ARCHS)
def test_every_arch_traces_each_kind_on_a_mesh(world, arch):
    """Each architecture's train, prefill and decode steps trace on a fake
    2 x 4 mesh (its MoE routing, sLSTM gates and caches included) with
    FLOPs, bytes and arguments counted on every one."""
    mesh = _mesh((2, 4))
    for kind in ("train", "prefill", "decode"):
        step, args = dryrun.build_step_and_args(
            arch, ShapeConfig("t", 32, 8, kind), mesh, False,
            cfg=_reduced(arch))
        c = dryrun.trace_costs(step, args)
        assert c["flops"] > 0 and c["bytes"] > 0, (arch, kind)
        assert c["memory"]["argument_bytes"] > 0, (arch, kind)


def test_cli_writes_a_full_config_record(tmp_path):
    """``python -m repro_torch.launch.dryrun`` on granite-8b's full config
    × decode_32k on the 256-rank mesh writes a record that the reference's
    roofline reads."""
    out = tmp_path / "dryrun_torch.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "granite-8b", "--shape", "decode_32k", "--out", str(out)],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "1 OK, 0 SKIP, 0 FAIL" in proc.stdout
    (rec,) = json.loads(out.read_text())
    from repro.launch.roofline import analyse
    a = analyse(rec)
    assert rec["mesh"] == "16x16" and a["dominant"] in (
        "compute", "memory", "collective")
