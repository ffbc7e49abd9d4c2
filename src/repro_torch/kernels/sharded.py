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
(``models.ssm.ssd``), split by heads as views; the one-token decode takes
them repeated to the heads first.

The one operand split otherwise is a decode cache split on its sequence
(the ``act_kv_seq`` rules, over one mesh dimension or several): each rank
runs the wrapper on its slice, with the slice's own lengths and key bounds
and the rows' log-sum-exp asked for, and the slices are combined across
the mesh dimensions that split the sequence, and only those: an
all-gather of the log-sum-exp and an all-reduce of the weighted outputs
and weights (``ref.combine_weights``, the weights of
``ref.combine_partials``).  That is the split-KV combine the reference
leaves to XLA (``repro/kernels/decode_attention.py:8-10``); it takes the
same path on ``cuda``, ``cpu`` and ``meta``.  A mesh dimension of size 1
splits nothing and issues no collective, so on a 1 × 1 mesh every
placement is local.
"""

from __future__ import annotations

import math

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from .ref import combine_weights, merge_weighted


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


def _kv_for(k, v, H: int, heads_dim: int, split: int,
            keep: tuple[int, ...] = (0,)):
    """k, v with their kv heads repeated to ``H`` where ``split`` ranks
    cannot take them as they take the query heads (their splits of the
    dims in ``keep`` kept)."""
    Hk = k.shape[heads_dim]
    if Hk % split == 0:
        return k, v
    G = H // Hk
    mesh = k.device_mesh
    out = []
    for t in (k, v):
        t = t.redistribute(mesh, _keep(t.placements, keep))
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


def ssd_decode(fn, state, x, log_a, b, c):
    """``fn`` on each rank's shard of state (B, H, N, P), x (B, 1, H, P),
    log_a (B, 1, H) and b, c (B, 1, H, N): batch and heads split alike,
    the update local to a head; the new state comes back split as the
    state."""
    mesh = x.device_mesh
    pl = _keep(x.placements, (0, 2))
    state_pl = _remap(pl, {0: 0, 2: 1})
    return _local_map(fn, mesh, (pl, state_pl), (state_pl, pl, pl, pl, pl),
                      state, x, log_a, b, c)


def decode_attention(fn, q, k, v, lengths, **kw):
    """``fn`` on each rank's shard of q (B, H, hd), k, v (B, Smax, Hk, hd)
    and lengths (B,): batch and heads split alike.  A cache split on Smax
    (over mesh dimensions of more than one rank) is combined across those
    dimensions (:func:`_split_kv`)."""
    mesh = q.device_mesh
    seq = [md for md, p in enumerate(k.placements)
           if isinstance(p, Shard) and p.dim == 1 and mesh.size(md) > 1]
    pl = tuple(Replicate() if md in seq else p
               for md, p in enumerate(_keep(q.placements, (0, 1))))
    kv_pl = tuple(Shard(1) if md in seq else p
                  for md, p in enumerate(_remap(pl, {0: 0, 1: 2})))
    k, v = _kv_for(k, v, q.shape[1], 2, _split(mesh, pl, 1),
                   keep=(0, 1) if seq else (0,))
    len_pl = _keep(pl, (0,))
    if not is_dtensor(lengths):
        lengths = DTensor.from_local(lengths, mesh,
                                     [Replicate()] * mesh.ndim,
                                     run_check=False)
    local = (lambda a, b, c, n: fn(a, b, c, n, **kw)) if not seq else \
        _split_kv(fn, mesh, seq, k.shape, kv_pl, **kw)
    return _local_map(local, mesh, pl, (pl, kv_pl, kv_pl, len_pl),
                      q, k, v, lengths)


def slice_bounds(lengths, off: int, size: int, window: int | None = None):
    """(lengths, starts) of a cache slice ``[off, off + size)``, int32:
    a row whose valid keys are ``[max(0, len - window), len)`` holds the
    slice's local keys ``[clamp(len - window - off), clamp(len - off))``,
    each clamped into ``[0, size]`` (starts 0 without a window)."""
    end = (lengths - off).clamp(0, size).to(torch.int32)
    if not window:
        return end, torch.zeros_like(end)
    return end, (lengths - window - off).clamp(0, size).to(torch.int32)


def _split_kv(fn, mesh, seq: list[int], kv_shape, kv_pl, *, window=None,
              **kw):
    """The local function of a decode over a cache split on its sequence
    by the mesh dimensions ``seq``: this rank's slice ``[off, off + Sl)``
    takes the lengths and starts :func:`slice_bounds` gives, computed from
    the replicated lengths inside the function; ``off`` is DTensor's own
    global offset of the slice.  ``fn`` gives the slice's output and
    log-sum-exp (o = 0 and -inf where the slice holds no valid key); the
    ranks of the ``seq`` dimensions then all-gather the log-sum-exp to its
    maximum M and all-reduce (w·o, w) with ``w = exp(lse - M)`` in fp32,
    and every rank divides."""
    from torch.distributed import _functional_collectives as funcol
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    # all_gather_single is all_gather_tensor's newer name (torch 2.13)
    gather = getattr(funcol, "all_gather_single", funcol.all_gather_tensor)
    shape, offset = compute_local_shape_and_global_offset(kv_shape, mesh,
                                                          kv_pl)
    Sl, off = shape[1], offset[1]

    def waited(t):
        return t.wait() if isinstance(t, funcol.AsyncCollectiveTensor) \
            else t

    def local(q, k, v, lengths):
        end, start = slice_bounds(lengths, off, Sl, window)
        o, lse = fn(q, k, v, end, starts=start, return_lse=True, **kw)
        M = lse
        for md in seq:
            M = waited(gather(M, 0, (mesh, md)))
            M = M.view(mesh.size(md), *lse.shape).amax(dim=0)
        w = combine_weights(lse, M)[..., None]
        part = torch.cat([w * o.float(), w], dim=-1)    # (B, H, hd + 1)
        for md in seq:
            part = waited(funcol.all_reduce(part, "sum", (mesh, md)))
        return merge_weighted(part[..., :-1], part[..., -1:], o.dtype)

    return local
