"""Carry the JAX package's parameters into the port.

:func:`to_torch` turns a pytree (nested dicts, lists, tuples) of numpy
arrays — the JAX package's parameters after ``np.asarray`` — into the same
tree of tensors on a given device.  Keys and dtypes are kept.  numpy has no
bfloat16 of its own: arrays that came from JAX carry ``ml_dtypes``'
``bfloat16``, which is carried over bit for bit through a ``uint16`` view
(without importing ``ml_dtypes``, which the card's host may lack).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ._device import resolve_device


def array_to_tensor(a: Any, device: str | torch.device = "cuda"
                    ) -> torch.Tensor:
    dev = resolve_device(device)
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy())
        t = t.view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(a).copy())
    return t.to(dev)


def to_torch(tree: Any, device: str | torch.device = "cuda") -> Any:
    """The same tree with every array leaf a tensor on ``device``."""
    if isinstance(tree, dict):
        return {k: to_torch(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_torch(v, device) for v in tree]
    if isinstance(tree, tuple):
        return tuple(to_torch(v, device) for v in tree)
    return array_to_tensor(tree, device)
