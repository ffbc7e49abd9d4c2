"""Step functions (train / prefill / decode) and the models' parameter and
FLOP counts: the port of ``repro/launch/steps.py``.

The reference's factories also take the sharding rules and the mesh, and
the module builds input specs and shardings for the production mesh; those
wait for the port of ``runtime/sharding.py`` (ROADMAP.md, slice E), so the
factories here take the model alone.
"""

from __future__ import annotations

import math

import torch

from ..configs.base import ModelConfig, ShapeConfig
from ..models import build_model
from ..models import layers as L
from ..models.moe import pad_experts
from ..optim import AdamWConfig, apply_updates


def value_and_grad(loss_fn, params, batch):
    """``loss_fn(params, batch)`` -> (loss, metrics), and its gradient with
    respect to every parameter leaf, as the reference's
    ``jax.value_and_grad(..., has_aux=True)``: (loss, metrics, grads), all
    detached.  The leaves are differentiated through detached views, so
    ``params`` itself never requires grad."""
    leaves = L.tree_leaves(params)
    live = [p.detach().requires_grad_() for p in leaves]
    loss, metrics = loss_fn(L.tree_unflatten(params, live), batch)
    grads = torch.autograd.grad(loss, live, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            L.tree_unflatten(params, grads))


def make_train_step(model, adamw_cfg: AdamWConfig):
    """One training step: the loss and its gradient, then AdamW, which
    updates ``params`` and ``opt_state`` in place.  Returns (params,
    opt_state, {"loss", "nll", "aux", "grad_norm", "lr"})."""
    def train_step(params, opt_state, batch):
        loss, metrics, grads = value_and_grad(model.loss, params, batch)
        params, opt_state, om = apply_updates(adamw_cfg, params, grads,
                                              opt_state)
        return params, opt_state, {"loss": loss, **metrics, **om}

    return train_step


def make_prefill_step(model):
    def prefill_step(params, cache, batch):
        kw = {}
        if "frames" in batch:
            kw["frames"] = batch["frames"]
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
# MODEL_FLOPS (the roofline's "useful work" yardstick)
# ---------------------------------------------------------------------------

def count_params(cfg: ModelConfig) -> int:
    spec = build_model(cfg, device="meta").spec()
    return sum(math.prod(p.shape) for p in L.tree_leaves(spec))


def count_active_params(cfg: ModelConfig) -> int:
    """Parameters one token meets: an MoE layer's experts beyond its top-k
    (the padded experts included) do not count."""
    n = count_params(cfg)
    if cfg.moe_experts:
        E = pad_experts(cfg.moe_experts)
        inactive = (E - cfg.moe_top_k) * 3 * cfg.d_model * cfg.d_ff
        n -= inactive * cfg.n_layers // len(cfg.pattern)
    return n


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """6·N·D for training, 2·N·D for inference (MoE: N_active)."""
    n = count_active_params(cfg)
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch          # one token per sequence
