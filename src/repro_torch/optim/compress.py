"""int8 error-feedback gradient compression for cross-pod all-reduce: the
port of ``repro/optim/compress.py``.

The reference reduces over a mesh axis name; the port reduces over a
``torch.distributed`` process group (None: the default group).  Per tensor:
the scale is all-reduced by MAX so every rank dequantises identically, the
int8 payload is requantised against it and summed as int32, and the sum is
divided by the world size.  ``torch.round`` rounds half to even, as
``jnp.round`` does, so both packages quantise alike.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..models.layers import tree_leaves, tree_unflatten


def quantize(g, residual=None):
    """Returns (int8 values, fp32 scale, new residual)."""
    g32 = g.float()
    if residual is not None:
        g32 = g32 + residual
    amax = g32.abs().max()
    scale = torch.clamp(amax / 127.0, min=1e-12)
    q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
    new_residual = g32 - q.float() * scale
    return q, scale, new_residual


def dequantize(q, scale):
    return q.float() * scale


def compressed_psum(g, group=None, residual=None):
    """The mean of ``g`` over ``group``'s ranks with an int8 payload and
    error feedback; returns (mean in g's dtype, new residual)."""
    _, scale, _ = quantize(g, residual)
    dist.all_reduce(scale, op=dist.ReduceOp.MAX, group=group)
    # requantise against the shared scale so the int8 sum is exact
    g32 = g.float() + (residual if residual is not None else 0.0)
    q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
    new_residual = g32 - q.float() * scale
    total = q.to(torch.int32)
    dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
    n = float(dist.get_world_size(group))
    return (total.float() * scale / n).to(g.dtype), new_residual


def tree_compressed_psum(grads, group=None, residuals=None):
    flat_g = tree_leaves(grads)
    flat_r = tree_leaves(residuals) if residuals is not None else \
        [None] * len(flat_g)
    out = [compressed_psum(g, group, r) for g, r in zip(flat_g, flat_r)]
    return tree_unflatten(grads, [o[0] for o in out]), \
        tree_unflatten(grads, [o[1] for o in out])
