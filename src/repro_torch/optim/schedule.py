"""LR schedules: the port of ``repro/optim/schedule.py``.  Each is a pure
function of the step (an int, or an integer tensor on any device) that
returns a float32 0-d tensor on the step's device."""

from __future__ import annotations

import math

import torch


def _step(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def cosine_with_warmup(peak_lr: float, warmup_steps: int, total_steps: int,
                       final_frac: float = 0.1):
    def schedule(step):
        step = _step(step)
        warm = peak_lr * step / max(warmup_steps, 1)
        prog = torch.clamp((step - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = final_frac + (1 - final_frac) * 0.5 * \
            (1.0 + torch.cos(math.pi * prog))
        return torch.where(step < warmup_steps, warm, peak_lr * cos)

    return schedule


def constant(lr: float):
    def schedule(step):
        return torch.full((), lr, dtype=torch.float32,
                          device=_step(step).device)

    return schedule
