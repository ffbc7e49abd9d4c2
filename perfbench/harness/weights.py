"""Weights drawn by the benchmark from the run's seed.

They fill the tree of shapes that the port's model declares (its
``spec()``: leaves with ``shape``, ``init`` and ``scale``), so the program
and the reference are handed the same tensors, and nothing the program's
own ``init`` makes is used.  Every normal leaf is a view of one flat buffer
drawn on the device in a few large calls, in the dtype it is served in,
then scaled leaf by leaf (``1/sqrt(shape[0])`` unless the leaf gives its
scale); ``zeros`` and ``ones`` leaves are filled.  The same seed gives the
same tensors, so :func:`draw` can be called again to get the initial
weights back after a training run has updated them in place.
"""

from __future__ import annotations

import math

import torch

# elements per draw: a few large calls
PIECE = 1 << 30


def generator(seed: int, device, salt: int = 0) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` for ``seed`` (any whole number;
    ``salt`` separates streams drawn from one seed)."""
    value = (int(seed) * 1_000_003 + salt) % (1 << 63)
    return torch.Generator(device=device).manual_seed(value)


def _leaves(spec, prefix=()):
    """(path, leaf) in sorted key order."""
    if isinstance(spec, dict):
        for k in sorted(spec):
            yield from _leaves(spec[k], prefix + (k,))
    else:
        yield prefix, spec


def _scale(leaf) -> float:
    if leaf.scale is not None:
        return float(leaf.scale)
    return 1.0 / math.sqrt(max(leaf.shape[0] if leaf.shape else 1, 1))


def count(spec) -> int:
    return sum(math.prod(leaf.shape) for _, leaf in _leaves(spec))


def draw(spec, seed: int, device, dtype=torch.bfloat16) -> dict:
    """The tree of ``spec`` with weights drawn from ``seed`` on
    ``device``."""
    leaves = list(_leaves(spec))
    normal = sum(math.prod(leaf.shape) for _, leaf in leaves
                 if leaf.init == "normal")
    flat = torch.empty(normal, dtype=dtype, device=device)
    gen = generator(seed, device)
    for piece in flat.split(PIECE):
        piece.normal_(generator=gen)
    tree: dict = {}
    offset = 0
    for path, leaf in leaves:
        n = math.prod(leaf.shape)
        if leaf.init == "normal":
            t = flat[offset:offset + n].view(leaf.shape).mul_(_scale(leaf))
            offset += n
        elif leaf.init == "zeros":
            t = torch.zeros(leaf.shape, dtype=dtype, device=device)
        elif leaf.init == "ones":
            t = torch.ones(leaf.shape, dtype=dtype, device=device)
        else:
            raise ValueError(f"leaf {'/'.join(path)}: init {leaf.init!r}")
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = t
    return tree


def leaves(tree, prefix=()):
    """(name, tensor) of a tree of tensors, in sorted key order."""
    for path, t in _leaves(tree, prefix):
        yield "/".join(path), t
