"""VLM / audio modality frontends, stubbed as the reference stubs them: the
port of ``repro/models/vision.py``.

The models take precomputed patch or frame embeddings; these helpers give
their shapes and a seeded synthetic generator for smoke runs.  The real
InternViT / Whisper-conv frontends are out of scope, as in the reference.
"""

from __future__ import annotations

import torch

from .._device import resolve_device
from ..core.graph import TensorSpec


def patch_embed_spec(batch: int, n_tokens: int, d_model: int) -> TensorSpec:
    return TensorSpec((batch, n_tokens, d_model), torch.bfloat16)


def frame_embed_spec(batch: int, n_frames: int, d_model: int) -> TensorSpec:
    return TensorSpec((batch, n_frames, d_model), torch.bfloat16)


def synthetic_embeds(seed: int, spec: TensorSpec,
                     device: str | torch.device = "cuda") -> torch.Tensor:
    """Normals times 0.02 in ``spec``'s dtype, drawn in fp32 on ``device``
    from a ``torch.Generator`` seeded by ``seed``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randn(spec.shape, generator=gen, device=dev) * 0.02
            ).to(spec.dtype)
