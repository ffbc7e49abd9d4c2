"""The port's sharded steps against its own unsharded ones, in spawned gloo
process groups on the CPU.

The reference's own SPMD check (``tests/test_sharding.py:130``) does not
pass, so the port's sharded train step is held against the port's
single-device step instead: the reference test's reduced granite config
on a 2 x 4 ``data x model`` mesh of eight ranks, with its 2e-2 loss bound.
On a 1 x 1 mesh every placement is local, and the sharded train, prefill
and decode steps give the unsharded steps' numbers bit for bit.  The file
imports no JAX: each spawned rank imports it.
"""

import multiprocessing as mp
import queue

import numpy as np
import pytest
import torch
import torch.distributed as dist

WAIT = 240          # seconds a spawned group may take, the whole of it


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


def _granite():
    from repro_torch.models import get_config
    return get_config("granite-8b").replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=256, remat=False, loss_seq_chunk=None)


def _spmd_rank(rank, world, store, out):
    """One rank of the 2 x 4 mesh: the sharded and the unsharded train
    step's losses, and where DTensor puts a dimension split over both
    axes."""
    import traceback
    try:
        dist.init_process_group("gloo", init_method=f"file://{store}",
                                world_size=world, rank=rank)
        from torch.distributed.device_mesh import init_device_mesh
        from repro_torch.configs.base import ShapeConfig
        from repro_torch.launch.steps import (make_train_step, rules_for,
                                              shard_args)
        from repro_torch.models import build_model
        from repro_torch.optim import AdamWConfig, init_state
        from repro_torch.runtime.sharding import _local_part, placements
        torch.set_num_threads(1)
        mesh = init_device_mesh("cpu", (2, 4),
                                mesh_dim_names=("data", "model"))
        # a dimension over ("data", "model"): row-major shard order
        whole = torch.arange(8 * 3, dtype=torch.float32).reshape(8, 3)
        from repro_torch.runtime.sharding import shard_tensor
        x = shard_tensor(whole, mesh, placements(mesh, (("data", "model"),)))
        coord = mesh.get_coordinate()
        chunk = coord[0] * 4 + coord[1]
        order = torch.equal(x.to_local(), whole[chunk:chunk + 1]) and \
            _local_part(x)[1] == (chunk, 0)

        cfg = _granite()
        model = build_model(cfg, device="cpu")
        shape = ShapeConfig("t", seq_len=32, global_batch=8, kind="train")
        rules = rules_for(shape, multi_pod=False)
        rng = np.random.default_rng(1)
        tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (8, 32),
                                               dtype=np.int32))
        batch = {"tokens": tokens, "labels": tokens.roll(-1, dims=1)}
        params = model.init(seed=0, dtype=torch.float32)
        _, _, m0 = make_train_step(model, AdamWConfig())(
            params, init_state(params), batch)
        params = model.init(seed=0, dtype=torch.float32)
        args = shard_args(cfg, shape, mesh, rules,
                          {"params": params, "opt_state": init_state(params),
                           "batch": batch})
        _, _, m1 = make_train_step(model, AdamWConfig(), rules=rules,
                                   mesh=mesh)(args["params"],
                                              args["opt_state"],
                                              args["batch"])
        out.put((rank, (float(m0["loss"]), float(m1["loss"]),
                        float(m0["grad_norm"]), float(m1["grad_norm"]),
                        order)))
    except Exception:                                   # noqa: BLE001
        out.put((rank, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_sharded_train_step_on_2x4_matches_single_device(tmp_path):
    """Eight gloo ranks, a 2 x 4 mesh: the sharded step's loss within 2e-2
    of the single-device step's (the reference test's bound), on every
    rank; a dimension split over both axes goes row-major, as a JAX
    ``NamedSharding`` lays it out."""
    res = _spawn(_spmd_rank, 8, tmp_path)
    for rank, (l0, l1, g0, g1, order) in res.items():
        assert abs(l0 - l1) / abs(l0) < 2e-2, (rank, l0, l1)
        assert abs(g0 - g1) / abs(g0) < 2e-2, (rank, g0, g1)
        assert order, rank


def _small(arch):
    from repro_torch.models import get_config
    cfg = get_config(arch)
    return cfg.replace(
        n_layers=4, d_model=64, n_heads=4,
        n_kv_heads=2 if cfg.n_kv_heads < cfg.n_heads else 4, head_dim=16,
        d_ff=128, vocab=256, ssm_state=16, ssm_head_dim=16, ssm_chunk=16,
        remat=True, loss_seq_chunk=16)


def _local(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def _one_rank(rank, world, store, out, arch):
    """Both runs of one arch on a 1 x 1 mesh: two train steps, then a
    prefill and four greedy decode steps; every number the steps give."""
    import traceback
    try:
        dist.init_process_group("gloo", init_method=f"file://{store}",
                                world_size=world, rank=rank)
        from repro_torch.configs.base import ShapeConfig
        from repro_torch.launch.mesh import make_smoke_mesh
        from repro_torch.launch.steps import (make_decode_step,
                                              make_prefill_step,
                                              make_train_step, rules_for,
                                              shard_args)
        from repro_torch.models import build_model
        from repro_torch.models import layers as L
        from repro_torch.optim import AdamWConfig, init_state
        torch.set_num_threads(1)
        mesh = make_smoke_mesh("cpu")
        cfg = _small(arch)
        model = build_model(cfg, device="cpu")
        rng = np.random.default_rng(2)
        tokens = torch.from_numpy(rng.integers(0, 256, (2, 32),
                                               dtype=np.int32))
        tshape = ShapeConfig("t", 32, 2, "train")
        pshape = ShapeConfig("p", 48, 2, "prefill")
        dshape = ShapeConfig("d", 48, 2, "decode")
        runs = []
        for sharded in (False, True):
            got = []
            params = model.init(seed=0, dtype=torch.float32)
            args = {"params": params, "opt_state": init_state(params),
                    "batch": {"tokens": tokens, "labels": tokens.roll(-1, 1)}}
            kw = {}
            if sharded:
                rules = rules_for(tshape, multi_pod=False)
                args = shard_args(cfg, tshape, mesh, rules, args)
                kw = dict(rules=rules, mesh=mesh)
            step = make_train_step(model, AdamWConfig(lr=1e-2), **kw)
            for _ in range(2):
                args["params"], args["opt_state"], m = step(
                    args["params"], args["opt_state"], args["batch"])
                got.append(m["loss"])
            got += [_local(p) for p in L.tree_leaves(args["params"])]

            params = model.init(seed=1, dtype=torch.bfloat16)
            args = {"params": params, "cache": model.init_cache(2, 48),
                    "batch": {"tokens": tokens[:, :20]}}
            pre, dec = make_prefill_step(model), make_decode_step(model)
            if sharded:
                pr, dr = (rules_for(s, multi_pod=False)
                          for s in (pshape, dshape))
                args = shard_args(cfg, pshape, mesh, pr, args)
                pre = make_prefill_step(model, rules=pr, mesh=mesh)
                dec = make_decode_step(model, rules=dr, mesh=mesh)
            with torch.no_grad():
                logits, cache = pre(args["params"], args["cache"],
                                    args["batch"])
                got.append(_local(logits))
                tok = torch.argmax(got[-1][:, -1], -1).to(torch.int32)
                tok = tok[:, None]
                for i in range(4):
                    d = {"token": tok,
                         "cache_len": torch.tensor(20 + i, dtype=torch.int32)}
                    if sharded:
                        d = shard_args(cfg, dshape, mesh, dr, d)
                    tok, logits, cache = dec(args["params"], cache,
                                             d["token"], d["cache_len"])
                    tok = _local(tok)
                    got += [_local(logits), tok]
            runs.append(got)
        out.put((rank, all(torch.equal(a, b) for a, b in zip(*runs))))
    except Exception:                                   # noqa: BLE001
        out.put((rank, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


@pytest.mark.parametrize("arch", ["granite-8b", "zamba2-2.7b"])
def test_sharded_steps_on_a_1x1_mesh_equal_the_unsharded(tmp_path, arch):
    """fp32 training (remat, loss chunks) for two steps, then a bf16
    prefill and four greedy decode steps: on a 1 x 1 mesh the sharded
    steps' losses, parameters, logits and tokens equal the unsharded
    steps' bit for bit."""
    res = _spawn(_one_rank, 1, tmp_path, arch)
    assert res[0] is True
