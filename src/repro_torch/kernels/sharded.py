"""The kernels inside a mesh: each wrapper, given DTensors, runs itself on
every rank's shard through ``torch.distributed.tensor.experimental
.local_map`` (the hand-written kernel on the card, the plain version on
the CPU or on ``meta``), so a sharded step launches the same kernels as an
unsharded one.

A kernel's operands may be split by batch and by heads only: the other
dimensions (the sequence, head_dim, a pending sum) are gathered first.  A
query-head split takes the kv heads with it, so that GQA's
``h // (H // Hk)`` stays local; where the kv heads do not divide as the
query heads do, k and v are repeated to H heads first, as the reference's
``sdpa`` repeats them.  SSD's b and c, head-shared stride-0 views
(``models.ssm.ssd``), split by heads as views.

The one operand a kernel cannot take split otherwise is a decode cache
split on its sequence (the ``act_kv_seq`` rule): its split-KV combine
across ranks is what the reference leaves to XLA
(``repro/kernels/decode_attention.py:8-10``).  On the card that raises
``NotImplementedError``; off it the plain version runs on the DTensors
themselves, whose operators combine the splits (the dry-run).  A mesh
dimension of size 1 splits nothing, so on a 1 × 1 mesh every placement is
local.
"""

from __future__ import annotations

import math

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard


def is_dtensor(x) -> bool:
    return isinstance(x, DTensor)


def _keep(placements, dims: tuple[int, ...]) -> tuple:
    """``placements`` with every ``Shard`` of a dim outside ``dims`` (and a
    pending sum) made ``Replicate``."""
    return tuple(p if isinstance(p, Shard) and p.dim in dims else Replicate()
                 for p in placements)


def _remap(placements, dims: dict[int, int]) -> tuple:
    """``placements`` with ``Shard(d)`` renamed to ``Shard(dims[d])``."""
    return tuple(Shard(dims[p.dim]) if isinstance(p, Shard) else p
                 for p in placements)


def _split(mesh, placements, dim: int) -> int:
    """How many ways ``placements`` split tensor dimension ``dim``."""
    return math.prod(mesh.size(md) for md, p in enumerate(placements)
                     if isinstance(p, Shard) and p.dim == dim)


def _local_map(fn, mesh, out_pl, in_pl, *args):
    """``local_map`` with placements given as tuples: ``out_pl`` one
    tuple for a single output, a tuple of them for several."""
    from torch.distributed.tensor.experimental import local_map
    out = tuple(map(list, out_pl)) if isinstance(out_pl[0], tuple) \
        else list(out_pl)
    return local_map(fn, out_placements=out, in_placements=in_pl,
                     device_mesh=mesh, redistribute_inputs=True)(*args)


def _kv_for(k, v, H: int, heads_dim: int, split: int):
    """k, v with their kv heads repeated to ``H`` where ``split`` ranks
    cannot take them as they take the query heads."""
    Hk = k.shape[heads_dim]
    if Hk % split == 0:
        return k, v
    G = H // Hk
    mesh = k.device_mesh
    out = []
    for t in (k, v):
        t = t.redistribute(mesh, _keep(t.placements, (0,)))
        shape = list(t.shape)
        t = t.unsqueeze(heads_dim + 1)
        exp = list(t.shape)
        exp[heads_dim + 1] = G
        shape[heads_dim] = H
        out.append(t.expand(exp).reshape(shape))
    return tuple(out)


def flash_attention(fn, q, k, v, **kw):
    """``fn`` (the wrapper) on each rank's shard of q (B, Sq, H, hd) and
    k, v (B, Sk, Hk, hd): batch and heads split alike."""
    mesh = q.device_mesh
    pl = _keep(q.placements, (0, 2))
    k, v = _kv_for(k, v, q.shape[2], 2, _split(mesh, pl, 2))
    return _local_map(lambda a, b, c: fn(a, b, c, **kw), mesh, pl,
                      (pl, pl, pl), q, k, v)


def ssd_scan(fn, x, log_a, b, c, **kw):
    """``fn`` on each rank's shard of x (B, S, H, P), log_a (B, S, H) and
    b, c (B, S, H, N): batch and heads split alike; the final state
    (B, H, N, P) comes back split as they are."""
    mesh = x.device_mesh
    pl = _keep(x.placements, (0, 2))
    state_pl = _remap(pl, {0: 0, 2: 1})
    return _local_map(lambda *a: fn(*a, **kw), mesh, (pl, state_pl),
                      (pl, pl, pl, pl), x, log_a, b, c)


def decode_attention(fn, ref, q, k, v, lengths, **kw):
    """``fn`` on each rank's shard of q (B, H, hd), k, v (B, Smax, Hk, hd)
    and lengths (B,): batch and heads split alike.  A cache split on Smax
    over more than one rank raises on the card; off it ``ref`` (the plain
    version) runs on the DTensors."""
    mesh = q.device_mesh
    if _split(mesh, k.placements, 1) > 1:
        if k.device.type == "cuda":
            raise NotImplementedError(
                "decode_attention over a cache split on its sequence across "
                "ranks: the kernel has no cross-rank split-KV combine "
                "(ROADMAP.md Queue 1)")
        q = q.redistribute(mesh, _keep(q.placements, (0,)))
        k, v = (t.redistribute(mesh, _keep(t.placements, (0, 1)))
                for t in (k, v))
        kw.pop("block_k", None)
        disp = DTensor._op_dispatcher      # the positions and lengths
        implicit, disp._allow_implicit_replication = \
            disp._allow_implicit_replication, True
        try:
            return ref(q, k, v, lengths, **kw)
        finally:
            disp._allow_implicit_replication = implicit
    pl = _keep(q.placements, (0, 1))
    kv_pl = _remap(pl, {0: 0, 1: 2})
    k, v = _kv_for(k, v, q.shape[1], 2, _split(mesh, pl, 1))
    len_pl = _keep(pl, (0,))
    if not is_dtensor(lengths):
        lengths = DTensor.from_local(lengths, mesh,
                                     [Replicate()] * mesh.ndim,
                                     run_check=False)
    return _local_map(lambda a, b, c, n: fn(a, b, c, n, **kw), mesh, pl,
                      (pl, kv_pl, kv_pl, len_pl), q, k, v, lengths)
