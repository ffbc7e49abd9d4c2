"""Carry the JAX package's parameters into the port.

:func:`to_torch` turns a pytree (nested dicts, lists, tuples) of numpy
arrays — the JAX package's parameters after ``np.asarray`` — into the same
tree of tensors on a given device.  Keys and dtypes are kept.  numpy has no
bfloat16 of its own: arrays that came from JAX carry ``ml_dtypes``'
``bfloat16``, which is carried over bit for bit through a ``uint16`` view
(without importing ``ml_dtypes``, which the card's host may lack).
:func:`adamw_state_to_torch` carries the JAX package's AdamW state, and
:func:`zoo_params_to_torch` a zoo net's weights into the layout of
``repro_torch.models.cnn_zoo``'s modules.
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


def adamw_state_to_torch(state: dict, device: str | torch.device = "cuda"
                         ) -> dict:
    """The JAX package's AdamW state (``{"mu", "nu", "step"}``, its arrays
    as numpy) as the port's ``optim.init_state`` layout on ``device``: fp32
    moments and an int32 0-d step."""
    return {"mu": to_torch(state["mu"], device),
            "nu": to_torch(state["nu"], device),
            "step": torch.tensor(int(np.asarray(state["step"])),
                                 dtype=torch.int32,
                                 device=resolve_device(device))}


def zoo_params_to_torch(params: dict[str, dict[str, Any]],
                        device: str | torch.device = "cuda"
                        ) -> dict[str, torch.Tensor]:
    """A zoo net's ``{node: {"w": ..., "b": ...}}`` numpy weights as the
    state dict of its ``cnn_zoo`` graph (``"<node>.weight"``,
    ``"<node>.bias"``): conv weights from HWIO (``(k, k, cin/groups,
    cout)``) to OIHW (``(cout, cin/groups, k, k)``), dense weights from
    ``(cin, cout)`` to ``(cout, cin)``."""
    out: dict[str, torch.Tensor] = {}
    for name, p in params.items():
        w = np.asarray(p["w"])
        w = w.transpose(3, 2, 0, 1) if w.ndim == 4 else w.T
        out[f"{name}.weight"] = array_to_tensor(w, device)
        out[f"{name}.bias"] = array_to_tensor(p["b"], device)
    return out
