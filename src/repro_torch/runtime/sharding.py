"""Logical-axis sharding rules (DP/FSDP/TP/SP/EP) for the model zoo: the
port of ``repro/runtime/sharding.py`` onto ``torch.distributed`` DTensors.

Model code annotates tensors with *logical* axes ("act_batch", "act_seq",
"heads", "ff", ...).  An :class:`AxisRules` table maps logical axes to mesh
axes; :func:`constrain` redistributes a DTensor to the placements the rules
give when a mesh is active, and returns its input untouched when no rules
are (so the same model code runs unsharded on one device, in serving and
CUDA-graph capture, and sharded on the production mesh).

Default production rules implement:

* DP    — batch over ``data`` (and ``pod`` when present),
* FSDP  — parameter ``embed`` dim over ``data``,
* TP    — ``heads`` / ``ff`` / ``vocab`` / ``experts`` over ``model``,
* SP    — inter-block activation ``act_seq`` over ``model``,
* EP    — MoE ``experts`` over ``model``.

A spec is the port's counterpart of JAX's ``PartitionSpec``: a tuple with
one entry per tensor dimension, each ``None``, a mesh axis name, or a tuple
of names, trailing ``None``\\ s dropped (so ``tuple(P(...))`` compares with
it).  :func:`placements` turns a spec into DTensor placements on a
``DeviceMesh`` whose ``mesh_dim_names`` are the axis names.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Any

import torch

Spec = tuple  # tuple[None | str | tuple[str, ...], ...]


@dataclass(frozen=True)
class AxisRules:
    rules: dict[str, tuple[str, ...] | None] = field(default_factory=dict)

    def spec(self, logical_axes: tuple[str | None, ...]) -> Spec:
        parts = []
        for ax in logical_axes:
            m = self.rules.get(ax) if ax is not None else None
            if m is None:
                parts.append(None)
            elif len(m) == 1:
                parts.append(m[0])
            else:
                parts.append(tuple(m))
        while parts and parts[-1] is None:
            parts.pop()
        return tuple(parts)

    def with_overrides(self, **kv) -> "AxisRules":
        new = dict(self.rules)
        new.update(kv)
        return AxisRules(new)


def single_pod_rules() -> AxisRules:
    return AxisRules({
        # activations
        "act_batch": ("data",),
        "act_seq": ("model",),       # SP between blocks
        "act_embed": None,
        "act_heads": ("model",),     # TP inside attention
        "act_ff": ("model",),
        "act_vocab": ("model",),
        "act_experts": ("model",),
        "act_kv_seq": ("model",),    # flash-decoding style KV split
        "act_kv_seq_full": ("data", "model"),  # batch=1 long-context decode
        # parameters
        "embed": ("data",),          # FSDP
        "heads": ("model",),
        "kv_heads": ("model",),
        "ff": ("model",),
        "vocab": ("model",),
        "experts": ("model",),
        "layers": None,
        "head_dim": None,
        "state": None,
        "conv": None,
        "unsharded": None,
    })


def multi_pod_rules() -> AxisRules:
    return single_pod_rules().with_overrides(
        act_batch=("pod", "data"),
        embed=("data",),             # FSDP stays intra-pod (cheap all-gather)
        act_kv_seq_full=("pod", "data", "model"),
    )


def smoke_rules() -> AxisRules:
    """Everything replicated."""
    return AxisRules({})


# -- thread-local active rules ------------------------------------------------

class _Ctx(threading.local):
    def __init__(self):
        self.rules: AxisRules | None = None
        self.mesh = None


_ctx = _Ctx()


class use_rules:
    """Context manager activating (rules, mesh) for :func:`constrain`.

    Under a mesh, a plain tensor that meets a DTensor in an operator (the
    positions, rope's frequencies, a mask the model builds) is taken as
    replicated on every rank, as JAX treats a constant under ``jit``."""

    def __init__(self, rules: AxisRules | None, mesh=None):
        self.rules, self.mesh = rules, mesh

    def __enter__(self):
        self._old = (_ctx.rules, _ctx.mesh)
        _ctx.rules, _ctx.mesh = self.rules, self.mesh
        if self.mesh is not None:
            from torch.distributed.tensor import DTensor
            disp = DTensor._op_dispatcher
            self._implicit = disp._allow_implicit_replication
            disp._allow_implicit_replication = True
        return self

    def __exit__(self, *exc):
        _ctx.rules, _ctx.mesh = self._old
        if self.mesh is not None:
            from torch.distributed.tensor import DTensor
            DTensor._op_dispatcher._allow_implicit_replication = \
                self._implicit
        return False


def active_rules() -> AxisRules | None:
    return _ctx.rules


def _mesh_sizes(mesh) -> dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _divisible_spec(mesh, spec: Spec, shape: tuple[int, ...]) -> Spec:
    """Drop mesh axes from dims they do not divide evenly (e.g. batch=1 in
    long-context decode, 1500-frame encoder sequences), and an axis already
    used by an earlier dim: a wrong placement is an error, an omitted one
    just costs a redistribution."""
    sizes = _mesh_sizes(mesh)
    parts = []
    used: set[str] = set()
    for i, p in enumerate(spec):
        if p is None or i >= len(shape):
            parts.append(None)
            continue
        axes = (p,) if isinstance(p, str) else tuple(p)
        if any(a in used for a in axes):   # an axis may shard only one dim
            parts.append(None)
            continue
        total = 1
        for a in axes:
            total *= sizes.get(a, 1)
        if total and shape[i] % total == 0:
            parts.append(p)
            used.update(axes)
        else:
            parts.append(None)
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


def placements(mesh, spec: Spec) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(i)`` on each mesh
    dimension that ``spec`` names for tensor dimension ``i``, ``Replicate()``
    on the rest.

    A dimension over several mesh axes is split by them in mesh order,
    which is DTensor's order and the row-major order of a JAX
    ``NamedSharding`` only when the spec lists them in that order; a spec
    that lists them otherwise raises."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    out: list = [Replicate()] * len(names)
    for i, p in enumerate(spec):
        if p is None:
            continue
        axes = (p,) if isinstance(p, str) else tuple(p)
        dims = []
        for a in axes:
            if a not in names:
                raise ValueError(f"mesh {names} has no axis {a!r}")
            dims.append(names.index(a))
        if dims != sorted(dims):
            raise ValueError(
                f"dim {i} is split over {axes}, out of the mesh's order "
                f"{names}: DTensor cannot give that shard order")
        for d in dims:
            if out[d] != Replicate():
                raise ValueError(f"mesh axis {names[d]!r} shards two dims")
            out[d] = Shard(i)
    return tuple(out)


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def constrain(x, *logical_axes: str | None):
    """Redistribute ``x`` to the placements of its logical axes under the
    active rules and mesh.  Returns ``x`` itself when no rules or no mesh
    are active; under a mesh ``x`` must be a DTensor (a step under a mesh
    takes DTensor inputs)."""
    rules, mesh = _ctx.rules, _ctx.mesh
    if rules is None or mesh is None:
        return x
    if not is_dtensor(x):
        raise TypeError(
            f"constrain{logical_axes}: a {type(x).__name__} under an active "
            f"mesh; a sharded step takes DTensor inputs")
    spec = _divisible_spec(mesh, rules.spec(logical_axes), tuple(x.shape))
    want = placements(mesh, spec)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(mesh, want)


def named_sharding(mesh, rules: AxisRules,
                   logical_axes: tuple[str | None, ...]) -> tuple:
    """The placements of ``logical_axes`` on ``mesh`` (no divisibility
    check, as the reference's ``NamedSharding`` of the bare spec)."""
    return placements(mesh, rules.spec(logical_axes))


def is_axes(x) -> bool:
    """A logical-axes leaf: a tuple of axis names and ``None`` (a tuple of
    such tuples, as the sLSTM's cache state, is a node)."""
    return isinstance(x, tuple) and all(a is None or isinstance(a, str)
                                        for a in x)


def map_axes(fn, axes_tree: Any, *rest: Any) -> Any:
    """``fn(axes, *leaves)`` over a tree of dicts and tuples whose leaves
    are logical-axes tuples, with ``rest`` trees of the same structure."""
    if is_axes(axes_tree):
        return fn(axes_tree, *rest)
    if isinstance(axes_tree, dict):
        return {k: map_axes(fn, v, *(r[k] for r in rest))
                for k, v in axes_tree.items()}
    if isinstance(axes_tree, tuple):
        return tuple(map_axes(fn, v, *(r[i] for r in rest))
                     for i, v in enumerate(axes_tree))
    raise TypeError(f"not an axes tree node: {axes_tree!r}")


def tree_shardings(mesh, rules: AxisRules, axes_tree):
    """Map a tree of logical-axes tuples to placements."""
    return map_axes(lambda axes: named_sharding(mesh, rules, axes),
                    axes_tree)


def distribute_tree(tree, mesh, placements_tree):
    """Each tensor of ``tree`` (dicts and tuples) as a DTensor of the
    placements at its place in ``placements_tree`` (:func:`shard_tensor`)."""
    if isinstance(tree, dict):
        return {k: distribute_tree(v, mesh, placements_tree[k])
                for k, v in tree.items()}
    if isinstance(tree, tuple):         # the sLSTM's four state tensors
        return tuple(distribute_tree(v, mesh, p)
                     for v, p in zip(tree, placements_tree))
    return shard_tensor(tree, mesh, placements_tree)


def shard_tensor(t: torch.Tensor, mesh, placements_: tuple):
    """``t``, a whole tensor on every rank, as a DTensor of ``placements_``
    on ``mesh``: on a mesh of one rank it wraps ``t`` itself (no copy),
    otherwise each rank keeps its shard."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    if mesh.size() == 1:
        return DTensor.from_local(t, mesh, placements_, run_check=False)
    return distribute_tensor(t, mesh, list(placements_))


def unflatten(x, dim: int, sizes):
    """``x.unflatten(dim, sizes)``.  A DTensor sharded on ``dim`` over mesh
    dimensions whose sizes ``sizes[0]`` does not take evenly (a
    projection's columns split over more ranks than it has heads) is first
    replicated on those: DTensor refuses an uneven view, where XLA would
    reshard."""
    if is_dtensor(x):
        from torch.distributed.tensor import Replicate, Shard
        mesh, dim = x.device_mesh, dim % x.ndim
        place, n = list(x.placements), 1
        for md, pl in enumerate(place):
            if isinstance(pl, Shard) and pl.dim == dim:
                n *= mesh.size(md)
                if sizes[0] % n:
                    n //= mesh.size(md)
                    place[md] = Replicate()
        if tuple(place) != tuple(x.placements):
            x = _Reshard.apply(x, tuple(place))
    return x.unflatten(dim, tuple(sizes))


def per_shard(fn, *tensors, dims: tuple[int, ...] | None = None,
              outputs: int = 1):
    """``fn(*tensors)``, on each rank's shard where the first is a DTensor:
    every argument keeps its splits on ``dims`` (all when None) and is
    gathered on the rest, and each of the ``outputs`` tensors ``fn``
    returns (one, or a tuple) is split as the first argument then is.
    For what DTensor has no rule for and needs none: an elementwise
    function, or index work within each row of dim 0 (the MoE's routing
    within its token groups)."""
    if not is_dtensor(tensors[0]):
        return fn(*tensors)
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    def keep(t):
        return [p if isinstance(p, Shard) and (dims is None or p.dim in dims)
                else Replicate() for p in t.placements]

    out = keep(tensors[0])
    return local_map(fn, out_placements=out if outputs == 1 else
                     (out,) * outputs,
                     in_placements=tuple(keep(t) for t in tensors),
                     device_mesh=tensors[0].device_mesh,
                     redistribute_inputs=True)(*tensors)


def flatten(x, start: int, end: int):
    """``x.flatten(start, end)``.  A DTensor sharded on a dimension after
    ``start`` in the range is first replicated there: only the leading
    dimension of a flattened group keeps its split (what every PyTorch
    release's DTensor views take)."""
    if is_dtensor(x):
        from torch.distributed.tensor import Replicate, Shard
        lo, hi = start % x.ndim, end % x.ndim
        place = tuple(Replicate() if isinstance(p, Shard) and lo < p.dim <= hi
                      else p for p in x.placements)
        if place != tuple(x.placements):
            x = _Reshard.apply(x, place)
    return x.flatten(start, end)


class _Reshard(torch.autograd.Function):
    """A redistribution whose gradient keeps the layout it arrives in
    (``redistribute`` sends it back to the input's, which would split the
    view's gradient unevenly again)."""

    @staticmethod
    def forward(ctx, x, place):
        return x.redistribute(x.device_mesh, place)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


# -- in-place writes into a sharded cache -------------------------------------
# DTensor refuses an in-place indexed write whose indices cross a sharded
# dimension; each rank writes the part that falls in its own shard.

def _local_part(x) -> tuple[torch.Tensor, tuple[int, ...]]:
    """This rank's shard of DTensor ``x`` (its storage) and the global
    index of the shard's first element along each dimension (even splits,
    in DTensor's mesh order)."""
    from torch.distributed.tensor import Shard
    mesh, local = x.device_mesh, x.to_local()
    coord = mesh.get_coordinate()
    offsets = []
    for d in range(x.ndim):
        idx = 0
        for md, p in enumerate(x.placements):
            if isinstance(p, Shard) and p.dim == d:
                idx = idx * mesh.size(md) + coord[md]
        offsets.append(idx * local.shape[d])
    return local, tuple(offsets)


def _aligned(src, dst, dims: dict[int, int]) -> torch.Tensor:
    """The local tensor of ``src`` split as ``dst`` is on the dimensions
    ``dims`` maps (src dim -> dst dim), whole on the rest."""
    from torch.distributed.tensor import Replicate, Shard
    back = {d: s for s, d in dims.items()}
    want = tuple(Shard(back[p.dim]) if isinstance(p, Shard) and p.dim in back
                 else Replicate() for p in dst.placements)
    return src.redistribute(dst.device_mesh, want).to_local()


def write_seq(cache, start: int, new) -> None:
    """``cache[:, start:start + S] = new`` for a (B, Smax, ...) cache and
    (B, S, ...) ``new`` (a prefill's rows)."""
    end = start + new.shape[1]
    if not is_dtensor(cache):
        cache[:, start:end] = new
        return
    local, off = _local_part(cache)
    part = _aligned(new, cache, {d: d for d in range(new.ndim) if d != 1})
    lo, hi = max(start, off[1]), min(end, off[1] + local.shape[1])
    if lo < hi:
        local[:, lo - off[1]:hi - off[1]] = part[:, lo - start:hi - start]


def write_rows(cache, at, new) -> None:
    """``cache[b, at[b]] = new[b]`` for a (B, Smax, ...) cache, (B,) long
    positions and (B, ...) ``new`` (a decode step's row of each slot), cast
    to the cache's dtype once its pending sums are reduced (a sum of
    partials each rounded to bf16 is not the sum rounded)."""
    if not is_dtensor(cache):
        rows = torch.arange(cache.shape[0], device=cache.device)
        cache[rows, at] = new.to(cache.dtype)
        return
    local, off = _local_part(cache)
    part = _aligned(new, cache, {0: 0, **{d: d + 1
                                          for d in range(1, new.ndim)}})
    if is_dtensor(at):
        at = at.full_tensor()
    rows = torch.arange(local.shape[0], device=local.device)
    pos = at[rows + off[0]] - off[1]
    mine = (pos >= 0) & (pos < local.shape[1])
    pos = pos.clamp(0, local.shape[1] - 1)
    keep = local[rows, pos]
    mine = mine.reshape(-1, *([1] * (keep.ndim - 1)))
    local[rows, pos] = torch.where(mine, part.to(local.dtype), keep)
