"""Multi-pod dry-run: trace every (architecture × input shape) step on the
production meshes and count its per-device costs: the port of
``repro/launch/dryrun.py``.

    python -m repro_torch.launch.dryrun --arch granite-8b --shape decode_32k
    python -m repro_torch.launch.dryrun --all [--multi-pod-only|--single-pod-only]
    python -m repro_torch.launch.dryrun --all --out results/dryrun_torch.json

Where the reference compiles each step for 512 emulated host devices, the
port runs it once, eagerly, on ``meta`` DTensors laid out by
``steps.shardings_for`` over the 256- or 512-rank mesh of a fake process
group (``launch/mesh.py``).  No device is touched and nothing is
allocated: it runs on any host, and is not an entry point that takes the
card.  Every layer, every chunk of the SSD scan and of the loss, and the
backward and AdamW run as they would, so each count covers the whole step;
the reference's two-point extrapolation over reduced depths (XLA's cost
analysis counts a loop body once) has nothing to recover here.

A dispatch mode (:class:`LocalCosts`) sees the operators each rank runs on
its local shards.  It counts each operator once, at its local shapes: the
DTensor-level call, and the shape inference DTensor runs at global shapes
under a fake mode, are not counted.  So every count is *per device*, for
rank 0 (the meshes split evenly, so every rank counts the same):

* ``hlo_flops_per_device``: ``torch.utils.flop_counter``'s FLOPs of each
  local operator (matrix products, convolutions, attention);
* ``hlo_bytes_per_device``: every local operator's inputs and outputs, as
  ``core.bench._BytesAccessed`` counts them (per unfused eager operator,
  views moving nothing);
* ``collectives``: the bytes of each collective's output, by kind, from
  the ``_c10d_functional`` operators DTensor issues (``wait_tensor`` is no
  second collective).  A shard-to-shard redistribution is an all-to-all;
  the CPU backend would run it as an all-gather and a chunk, so during the
  trace DTensor is handed the all-to-all operator itself, and it is
  counted as one;
* ``memory``: ``argument_bytes`` the local shards of the step's arguments,
  ``output_bytes`` those of its results, ``alias_bytes`` the results that
  are arguments updated in place (parameters, moments, caches), and
  ``temp_bytes`` the largest live set of local storage that the trace
  allocates beyond the arguments.  On ``meta`` the kernels' wrappers run
  their plain versions on each shard (``kernels/sharded.py``), which hold
  whole score tensors (attention's ``(B, H, Sq, Sk)`` in fp32, the SSD's
  ``(L, L)`` chunk scores) that the kernels never hold: ``temp_bytes``
  includes them, so it bounds the card's need from above.

The ``hlo_*`` keys keep the reference's names, so that both
``repro.launch.roofline.analyse`` and the port's read a record; here they
are eager-trace counts, not HLO's.  ``collectives_scan_body_once`` equals
``collectives``: the eager trace has no loop body counted once.
"""

from __future__ import annotations

import argparse
import json
import os
import time
import traceback
import weakref

import torch
from torch.utils._pytree import tree_leaves

from ..configs.base import ALL_SHAPES, ShapeConfig, shape_by_name
from ..core.bench import _BytesAccessed
from ..models import build_model, get_config
from ..optim import AdamWConfig
from ..runtime.sharding import distribute_tree
from .mesh import make_production_mesh
from .steps import (input_specs, make_decode_step, make_prefill_step,
                    make_train_step, model_flops, rules_for, shardings_for)

ARCHS = ["gemma2-9b", "starcoder2-15b", "gemma-7b", "granite-8b",
         "zamba2-2.7b", "xlstm-125m", "whisper-medium", "internvl2-76b",
         "qwen2-moe-a2.7b", "granite-moe-3b-a800m"]


# long_500k needs sub-quadratic attention
def cell_skipped(arch: str, shape: ShapeConfig) -> str | None:
    cfg = get_config(arch)
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return "full-attention arch: 512k decode KV is quadratic-infeasible"
    return None


_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                "collective-permute")
_KIND = {"all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
         "all_gather_into_tensor": "all-gather",
         "all_gather_into_tensor_coalesced": "all-gather",
         "reduce_scatter_tensor": "reduce-scatter",
         "reduce_scatter_tensor_coalesced": "reduce-scatter",
         "all_to_all_single": "all-to-all",
         "shard_dim_alltoall": "all-to-all"}
_NOT_COLLECTIVES = {"wait_tensor", "_wrap_tensor_autograd"}


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _storage_key(t) -> int:
    return t.untyped_storage()._cdata


class LocalCosts(_BytesAccessed):
    """Per-device FLOPs, bytes, collective bytes by kind and the peak of
    live storage, over the local operators of a DTensor step (see the
    module docstring)."""

    def __init__(self, arguments=()):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._flops = flop_registry
        self.flops = 0
        self.collectives = {c: 0.0 for c in _COLLECTIVES}
        self._args = {_storage_key(t) for t in arguments}
        self._refs: dict[int, int] = {}
        self._sizes: dict[int, int] = {}
        self.live = self.peak = 0
        self.inferring = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(isinstance(t, DTensor) for t in tree_leaves((args, kwargs))):
            return NotImplemented       # DTensor runs the local operators
        out = func(*args, **kwargs)
        if self.inferring or torch._C._get_dispatch_mode(
                torch._C._TorchDispatchModeKey.FAKE) is not None:
            return out                  # DTensor's global shape inference
        ns = func.namespace
        name = func._overloadpacket.__name__
        if ns in ("_c10d_functional", "_dtensor") and \
                name not in _NOT_COLLECTIVES:
            kind = _KIND.get(name, name)
            self.collectives[kind] = self.collectives.get(kind, 0.0) + sum(
                _nbytes(t) for t in tree_leaves(out)
                if isinstance(t, torch.Tensor))
        elif ns not in ("_c10d_functional", "_dtensor"):
            if func._overloadpacket in self._flops:
                self.flops += self._flops[func._overloadpacket](
                    *args, **kwargs, out_val=out)
            self.count(func, args, kwargs, out)
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self._track(t)
        return out

    def _track(self, t):
        key = _storage_key(t)
        if key in self._args:
            return
        if key not in self._refs:
            self._refs[key] = 0
            self._sizes[key] = t.untyped_storage().nbytes()
            self.live += self._sizes[key]
            self.peak = max(self.peak, self.live)
        self._refs[key] += 1
        weakref.finalize(t, self._release, key)

    def _release(self, key):
        self._refs[key] -= 1
        if not self._refs[key]:
            del self._refs[key]
            self.live -= self._sizes.pop(key)


class _Inference:
    """Marks the operators DTensor runs to choose an operator's sharding
    or plan a redistribution (on a cache miss: local shapes, strategies
    from decompositions, on ``meta`` tensors at global shapes) as no work
    of the step, so that a count does not depend on what ran before."""

    NAMES = ("propagate_op_sharding", "propagate_op_sharding_non_cached")

    def __init__(self, counter: LocalCosts):
        from torch.distributed.tensor import DTensor
        self.counter = counter
        self.prop = DTensor._op_dispatcher.sharding_propagator

    def _wrap(self, run):
        def inferring(*args, **kwargs):
            self.counter.inferring += 1
            try:
                return run(*args, **kwargs)
            finally:
                self.counter.inferring -= 1
        return inferring

    def __enter__(self):
        from torch.distributed.tensor import _redistribute
        # (object, name, what the object itself held); a name a PyTorch
        # release lacks is left alone
        self.saved = [(obj, name, vars(obj).get(name))
                      for obj, name in [(self.prop, n) for n in self.NAMES]
                      + [(_redistribute, "_gen_transform_infos_non_cached")]
                      if hasattr(obj, name)]
        for obj, name, _ in self.saved:
            setattr(obj, name, self._wrap(getattr(obj, name)))
        return self

    def __exit__(self, *exc):
        for obj, name, old in self.saved:
            if old is None:         # a method of the class
                delattr(obj, name)
            else:
                setattr(obj, name, old)
        return False


class _AllToAll:
    """During the trace, DTensor's shard-to-shard redistribution issues the
    all-to-all operator itself rather than the CPU backend's all-gather and
    chunk (the fake group moves nothing either way)."""

    def __enter__(self):
        from torch.distributed.tensor import placement_types
        self._mod = placement_types
        self._old = getattr(placement_types, "shard_dim_alltoall", None)
        if self._old is not None:
            placement_types.shard_dim_alltoall = self._alltoall
        return self

    @staticmethod
    def _alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
        return torch.ops._dtensor.shard_dim_alltoall(
            input, gather_dim, shard_dim, mesh.get_group(mesh_dim).group_name)

    def __exit__(self, *exc):
        if self._old is not None:
            self._mod.shard_dim_alltoall = self._old
        return False


def build_step_and_args(arch: str, shape: ShapeConfig, mesh, multi_pod: bool,
                        cfg=None):
    """The cell's step and its arguments, ``meta`` DTensors on ``mesh``."""
    cfg = cfg if cfg is not None else get_config(arch)
    model = build_model(cfg, device="meta")
    rules = rules_for(shape, multi_pod=multi_pod)
    specs = input_specs(cfg, shape)
    shards = shardings_for(cfg, shape, mesh, rules, specs)
    if shape.kind == "train":
        step = make_train_step(model, AdamWConfig(), rules=rules, mesh=mesh)
        keys = ("params", "opt_state", "batch")
    elif shape.kind == "prefill":
        step = make_prefill_step(model, rules=rules, mesh=mesh)
        keys = ("params", "cache", "batch")
    else:
        step = make_decode_step(model, rules=rules, mesh=mesh)
        keys = ("params", "cache", "token", "cache_len")
    args = tuple(distribute_tree(specs[k], mesh, shards[k]) for k in keys)
    return step, args


def _local(tree) -> list[torch.Tensor]:
    return [t.to_local() if hasattr(t, "to_local") else t
            for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def trace_costs(step, args) -> dict:
    """Run ``step(*args)`` once under :class:`LocalCosts`: per-device
    FLOPs, bytes, collective bytes by kind and memory."""
    arg_locals = _local(args)
    arg_keys = {_storage_key(t) for t in arg_locals}
    counter = LocalCosts(arg_locals)
    with _AllToAll(), _Inference(counter), counter:
        out = step(*args)
    out_locals = _local(out)
    coll = dict(counter.collectives)
    coll["total"] = sum(v for k, v in coll.items())
    return {
        "flops": float(counter.flops),
        "bytes": float(counter.nbytes),
        "collectives": coll,
        "memory": {
            "argument_bytes": sum(map(_nbytes, arg_locals)),
            "output_bytes": sum(map(_nbytes, out_locals)),
            "temp_bytes": int(counter.peak),
            "alias_bytes": sum(_nbytes(t) for t in out_locals
                               if _storage_key(t) in arg_keys),
        },
    }


def run_cell(arch: str, shape: ShapeConfig, *, multi_pod: bool,
             verbose: bool = True, cfg=None) -> dict:
    """One cell's record; ``cfg`` replaces the registered config (tests
    run reduced ones)."""
    mesh_name = "2x16x16" if multi_pod else "16x16"
    rec = {"arch": arch, "shape": shape.name, "mesh": mesh_name}
    skip = cell_skipped(arch, shape)
    if skip:
        rec.update(status="SKIP", reason=skip)
        return rec

    t0 = time.time()
    try:
        mesh = make_production_mesh(multi_pod=multi_pod)
        full_cfg = cfg if cfg is not None else get_config(arch)
        step, args = build_step_and_args(arch, shape, mesh, multi_pod,
                                         cfg=full_cfg)
        costs = trace_costs(step, args)
        t_trace = time.time() - t0
        coll = costs["collectives"]
        rec.update(
            status="OK",
            lower_s=0.0,
            compile_s=round(t_trace, 1),
            n_devices=mesh.size(),
            hlo_flops_per_device=costs["flops"],
            hlo_bytes_per_device=costs["bytes"],
            collective_bytes_per_device=coll["total"],
            collectives=coll,
            collectives_scan_body_once=dict(coll),
            memory=costs["memory"],
            model_flops_total=model_flops(full_cfg, shape),
        )
        if verbose:
            print(f"[{arch} × {shape.name} × {mesh_name}] OK "
                  f"trace={t_trace:.0f}s "
                  f"flops/dev={costs['flops']:.3e} "
                  f"bytes/dev={costs['bytes']:.3e} "
                  f"coll/dev={coll['total']:.3e} "
                  f"temp={costs['memory']['temp_bytes'] / 2**30:.2f}GiB")
    except Exception as e:  # noqa: BLE001 — a failing cell is a bug report
        rec.update(status="FAIL", error=f"{type(e).__name__}: {e}",
                   trace=traceback.format_exc()[-2000:])
        if verbose:
            print(f"[{arch} × {shape.name} × {mesh_name}] FAIL: "
                  f"{rec['error']}")
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--single-pod-only", action="store_true")
    ap.add_argument("--multi-pod-only", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    cells: list[tuple[str, ShapeConfig, bool]] = []
    if args.all:
        meshes = [False, True]
        if args.single_pod_only:
            meshes = [False]
        if args.multi_pod_only:
            meshes = [True]
        for arch in ARCHS:
            for shape in ALL_SHAPES:
                for mp in meshes:
                    cells.append((arch, shape, mp))
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        cells.append((args.arch, shape_by_name(args.shape), args.multi_pod))

    results = [run_cell(a, s, multi_pod=mp) for a, s, mp in cells]

    ok = sum(r["status"] == "OK" for r in results)
    skip = sum(r["status"] == "SKIP" for r in results)
    fail = sum(r["status"] == "FAIL" for r in results)
    print(f"\n== dry-run: {ok} OK, {skip} SKIP, {fail} FAIL "
          f"of {len(results)} cells ==")

    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
        print(f"wrote {args.out}")
    return 1 if fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
