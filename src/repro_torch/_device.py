"""Device selection shared by the port's entry points.

Every entry point takes an explicit ``device`` that defaults to ``"cuda"``:
measurements and kernels belong on the card, and a run that finds no card
fails here instead of silently timing the CPU.  Tests pass ``device="cpu"``.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but CUDA is not available; "
            "pass device='cpu' to run the plain PyTorch versions on the CPU")
    return dev


def synchronize(device: torch.device) -> None:
    """Wait for all queued work on ``device`` (a no-op off the card)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
