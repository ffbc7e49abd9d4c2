"""AdamW with bf16 params / fp32 moments and global-norm clipping: the port
of ``repro/optim/adamw.py``.

Plain functions on the port's dict trees of tensors, with the reference's
arithmetic: fp32 moments, bias correction, decay only on tensors of two or
more dimensions, and the fp32 update cast back to the parameter's dtype.
:func:`apply_updates` writes the parameters and the state in place, under
``torch.no_grad()``: the counterpart of the reference's donated buffers
(``donate_argnums=(0, 1)``).  PyTorch's own optimisers are not used; their
arithmetic is not the reference's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from ..models.layers import tree_leaves, tree_map


@dataclass(frozen=True)
class AdamWConfig:
    lr: float | Callable[[torch.Tensor], torch.Tensor] = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float | None = 1.0


def init_state(params):
    """Optimizer state on the parameters' device: fp32 first and second
    moments laid out as the parameters (DTensors of their placements under
    a mesh) and an int32 step counter."""
    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else None

    def zeros(p):
        return torch.zeros_like(p, dtype=torch.float32,
                                memory_format=torch.contiguous_format)

    return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree) -> torch.Tensor:
    leaves = [g.float().square().sum() for g in tree_leaves(tree)]
    return torch.sqrt(sum(leaves))


def clip_by_global_norm(grads, max_norm: float):
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), norm


@torch.no_grad()
def apply_updates(cfg: AdamWConfig, params, grads, state):
    """One AdamW step, in place.  Returns (params, state, metrics), the
    same ``params`` and ``state`` objects, updated."""
    step = state["step"] + 1
    lr = cfg.lr(step) if callable(cfg.lr) else \
        torch.tensor(cfg.lr, dtype=torch.float32, device=step.device)

    gnorm = global_norm(grads)
    if cfg.clip_norm is not None:
        grads, _ = clip_by_global_norm(grads, cfg.clip_norm)

    b1, b2 = cfg.b1, cfg.b2
    c1 = 1.0 - b1 ** step.float()
    c2 = 1.0 - b2 ** step.float()

    for p, g, mu, nu in zip(tree_leaves(params), tree_leaves(grads),
                            tree_leaves(state["mu"]),
                            tree_leaves(state["nu"]), strict=True):
        g32 = g.float()
        mu.mul_(b1).add_((1 - b1) * g32)
        nu.mul_(b2).add_((1 - b2) * g32.square())
        delta = (mu / c1) / (torch.sqrt(nu / c2) + cfg.eps)
        if cfg.weight_decay and p.ndim >= 2:     # no decay on norms/biases
            delta = delta + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * delta)
    state["step"].copy_(step)
    return params, state, {"grad_norm": gnorm, "lr": lr}
