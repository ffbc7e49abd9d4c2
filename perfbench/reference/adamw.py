"""AdamW as the training configuration states it, in plain PyTorch: fp32
moments with bias correction, the gradient clipped to a global norm, decay
on tensors of two or more dimensions, the fp32 update stored back in the
parameters' dtype (bf16)."""

from __future__ import annotations

import torch


def global_norm(grads) -> torch.Tensor:
    return torch.sqrt(sum(g.float().square().sum() for g in grads))


@torch.no_grad()
def step(opt: dict, params: list, grads: list, t: int, lr: float, b1: float,
         b2: float, eps: float, weight_decay: float, clip_norm: float):
    """Step ``t`` (from 1) over parallel lists of stored parameters and
    fp32 gradients; ``opt`` holds ``mu`` and ``nu`` lists.  Returns the
    clipped gradients (what the moments take)."""
    norm = global_norm(grads)
    scale = torch.clamp(clip_norm / torch.clamp(norm, min=1e-9), max=1.0)
    clipped = [g.float() * scale for g in grads]
    c1, c2 = 1.0 - b1 ** t, 1.0 - b2 ** t
    for p, g, mu, nu in zip(params, clipped, opt["mu"], opt["nu"]):
        mu.mul_(b1).add_((1 - b1) * g)
        nu.mul_(b2).add_((1 - b2) * g.square())
        delta = (mu / c1) / (torch.sqrt(nu / c2) + eps)
        if weight_decay and p.ndim >= 2:
            delta = delta + weight_decay * p.float()
        p.copy_(p.float() - lr * delta)
    return clipped
