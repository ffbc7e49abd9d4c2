"""Step functions (prefill / decode) and the dense model's parameter and
FLOP counts: the port of ``repro/launch/steps.py``.

The reference's factories also take the sharding rules and the mesh, and
the module builds input specs and shardings for the production mesh; those
wait for the port of ``runtime/sharding.py`` (ROADMAP.md, slice E), so the
factories here take the model alone.  The train step waits for the port of
the optimizer and ``loss``.
"""

from __future__ import annotations

import math

import torch

from ..configs.base import ModelConfig, ShapeConfig
from ..models import build_model
from ..models import layers as L


def make_prefill_step(model):
    def prefill_step(params, cache, batch):
        kw = {}
        if "patch_embeds" in batch:
            kw["patch_embeds"] = batch["patch_embeds"]
        return model.prefill(params, batch["tokens"], cache, **kw)

    return prefill_step


def make_decode_step(model):
    def decode_step(params, cache, token, cache_len):
        logits, cache = model.decode_step(params, token, cache, cache_len)
        # greedy next token: what the serving engine feeds back
        next_tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
        return next_tok, logits, cache

    return decode_step


# ---------------------------------------------------------------------------
# MODEL_FLOPS (the roofline's "useful work" yardstick), dense models
# ---------------------------------------------------------------------------

def count_params(cfg: ModelConfig) -> int:
    spec = build_model(cfg, device="meta").spec()
    return sum(math.prod(p.shape) for p in L.tree_leaves(spec))


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """6·N·D for training, 2·N·D for inference.  MoE configs (whose N is
    the active count) wait for the port of ``moe.py``."""
    if cfg.moe_experts:
        raise NotImplementedError(
            f"{cfg.name}: MoE FLOPs wait for the port of moe.py "
            "(ROADMAP.md Queue 1)")
    n = count_params(cfg)
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch          # one token per sequence
