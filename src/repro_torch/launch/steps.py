"""Step functions (train / prefill / decode), input specs and shardings,
and the models' parameter and FLOP counts: the port of
``repro/launch/steps.py``.

The factories take the sharding rules and a ``DeviceMesh`` as keywords
and enter :func:`runtime.sharding.use_rules` around the step.  Without a
mesh a step runs on plain tensors; under one its inputs are DTensors laid
out as :func:`shardings_for` says, and the kernels run on each rank's shard
(``kernels/sharded.py``).  The dry-run, the trainer and the serving engine
all build their steps here.

On the card the decode step of a decoder-only model replays itself as
CUDA graphs cut at each ``decode_attention`` call (:class:`_DecodeGraphs`);
the ``decode_graph_captures`` and ``decode_graph_replays`` counters of
:mod:`..tracing` count its captures and replays.

Spans (:mod:`..tracing`): ``step.prefill``, ``step.decode`` (``graphed``:
whether the call was a replay) and ``step.train``, inside which
``train.forward``, ``train.backward`` and ``train.optimizer`` carry CUDA
events on the card.
"""

from __future__ import annotations

import math
from typing import Any

import torch

from .. import _device
from ..configs.base import ModelConfig, ShapeConfig
from ..models import build_model
from ..models import layers as L
from ..models.moe import pad_experts
from ..optim import AdamWConfig, apply_updates
from .. import tracing
from ..runtime.sharding import (AxisRules, _divisible_spec, constrain,
                                distribute_tree, is_dtensor, map_axes,
                                multi_pod_rules, placements,
                                single_pod_rules, use_rules)


def value_and_grad(loss_fn, params, batch):
    """``loss_fn(params, batch)`` -> (loss, metrics), and its gradient with
    respect to every parameter leaf, as the reference's
    ``jax.value_and_grad(..., has_aux=True)``: (loss, metrics, grads), all
    detached.  The leaves are differentiated through detached views, so
    ``params`` itself never requires grad."""
    leaves = L.tree_leaves(params)
    live = [p.detach().requires_grad_() for p in leaves]
    on_card = batch["tokens"].device.type == "cuda"
    with tracing.span("train.forward", device=on_card):
        loss, metrics = loss_fn(L.tree_unflatten(params, live), batch)
    with tracing.span("train.backward", device=on_card):
        grads = torch.autograd.grad(loss, live, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            L.tree_unflatten(params, grads))


def _whole(t):
    """A DTensor metric as the plain tensor every rank holds."""
    return t.full_tensor() if is_dtensor(t) else t


def make_train_step(model, adamw_cfg: AdamWConfig, *,
                    rules: AxisRules | None = None, mesh=None):
    """One training step: the loss and its gradient, then AdamW, which
    updates ``params`` and ``opt_state`` in place.  Returns (params,
    opt_state, {"loss", "nll", "aux", "grad_norm", "lr"}).

    Under a mesh each gradient is laid out as its parameter before AdamW
    (a pending data-parallel sum becomes a reduce-scatter, which XLA
    inserts by itself), and the metrics come back whole."""
    def train_step(params, opt_state, batch):
        with tracing.span("step.train"), use_rules(rules, mesh):
            loss, metrics, grads = value_and_grad(model.loss, params, batch)
            if mesh is not None:
                leaves = L.tree_leaves(params)
                grads = L.tree_unflatten(params, [
                    g.redistribute(p.device_mesh, p.placements)
                    for p, g in zip(leaves, L.tree_leaves(grads))])
            with tracing.span("train.optimizer",
                              device=batch["tokens"].device.type == "cuda"):
                params, opt_state, om = apply_updates(adamw_cfg, params,
                                                      grads, opt_state)
            out = {"loss": loss, **metrics, **om}
            if mesh is not None:
                out = {k: _whole(v) for k, v in out.items()}
            return params, opt_state, out

    return train_step


def make_prefill_step(model, *, rules: AxisRules | None = None, mesh=None):
    def prefill_step(params, cache, batch):
        with tracing.span("step.prefill"), use_rules(rules, mesh):
            kw = {}
            if "frames" in batch:
                kw["frames"] = batch["frames"]
            if "patch_embeds" in batch:
                kw["patch_embeds"] = batch["patch_embeds"]
            return model.prefill(params, batch["tokens"], cache, **kw)

    return prefill_step


class _DecodeGraphs:
    """A decode step replayed as CUDA graphs, for one cache at a time.

    The first call on a cache runs the step eagerly (the call's own step,
    and the warm-up of what the capture then records) and captures the
    step into one private memory pool as a chain of graphs
    (:func:`.._device.capture_chain`), cut at each attention layer's
    ``decode_attention`` call: the first graph runs the embedding and
    layer 0 up to its attention call, each next one the rest of a layer and
    the next layer up to its call (recurrent and MoE layers fall whole
    inside one), the last the last layer's remainder, the final norm, the
    unembedding and the argmax.  Every later call copies the token and the
    lengths into the static buffers the graphs read and replays the chain,
    with one eager ``decode_attention`` launch between two graphs, looked
    up as ``layers.decode_attention`` at that moment so that every wrapper
    in place sees every call; it writes the buffer the next graph reads.
    The same kernels run in the same order on the same inputs as the eager
    step.

    The capture is keyed by the cache's and the parameters' leaves (address,
    shape, stride, dtype) and the width: a call on another cache captures
    anew and frees the previous chain.  The returned token and logits are
    copies, the cache the caller's own leaves, written in place."""

    def __init__(self, step):
        self.step = step
        self.key = None
        self.chain = None
        self.token = self.lengths = None

    @staticmethod
    def _key(params, cache, token) -> tuple:
        return (tuple(token.shape),
                *((t.data_ptr(), tuple(t.shape), t.stride(), t.dtype)
                  for t in L.tree_leaves((params, cache))))

    def __call__(self, params, cache, token, cache_len):
        """The step's (next_tok, logits, cache), and whether it replayed."""
        key = self._key(params, cache, token)
        if key != self.key:
            self.release()
            out = self.step(params, cache, token, cache_len)
            self.token = token.clone()
            self.lengths = torch.empty(token.shape[0], dtype=torch.int32,
                                       device=token.device)
            self.chain = _device.capture_chain(
                self.step, (params, cache, self.token, self.lengths),
                token.device, L, "decode_attention")
            self.key = key
            tracing.count("decode_graph_captures")
            return out, False
        self.token.copy_(token)
        self.lengths.copy_(torch.as_tensor(cache_len, dtype=torch.int32,
                                           device=token.device))
        next_tok, logits, _ = self.chain.replay()
        tracing.count("decode_graph_replays")
        return (next_tok.clone(), logits.clone(), cache), True

    def release(self) -> None:
        if self.chain is not None:
            self.chain.release()
        self.key = self.chain = self.token = self.lengths = None


def _graphed(model, mesh, token) -> bool:
    """Whether a decode step replays as CUDA graphs: plain CUDA tensors
    under no mesh, for a decoder-only model.  The CPU and ``meta`` run the
    plain versions and DTensors the sharded kernels, eagerly.  The
    encoder-decoder stays eager: its cross-attention calls the kernel
    under ``encdec``'s own name, which the cut does not see."""
    return (mesh is None and token.device.type == "cuda"
            and not is_dtensor(token) and not model.cfg.is_encdec)


def make_decode_step(model, *, rules: AxisRules | None = None, mesh=None):
    def step(params, cache, token, cache_len):
        logits, cache = model.decode_step(params, token, cache, cache_len)
        # greedy next token: what the serving engine feeds back (over the
        # whole vocabulary: gathered under a mesh)
        last = constrain(logits[:, -1], "act_batch", None)
        next_tok = torch.argmax(last, dim=-1).to(torch.int32)[:, None]
        return next_tok, logits, cache

    graphs = _DecodeGraphs(step)

    def decode_step(params, cache, token, cache_len):
        with tracing.span("step.decode") as sp, use_rules(rules, mesh):
            if not _graphed(model, mesh, token):
                sp.set(graphed=False)
                return step(params, cache, token, cache_len)
            out, replayed = graphs(params, cache, token, cache_len)
            sp.set(graphed=replayed)
            return out

    return decode_step


# ---------------------------------------------------------------------------
# input specs (meta tensors — no allocation)
# ---------------------------------------------------------------------------

def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict[str, Any]:
    B, S = shape.global_batch, shape.seq_len
    i32 = torch.int32
    if cfg.is_encdec:
        return {"tokens": _meta((B, S), i32), "labels": _meta((B, S), i32),
                "frames": _meta((B, cfg.encoder_len, cfg.d_model),
                                torch.bfloat16)}
    if cfg.n_img_tokens:
        S_text = S - cfg.n_img_tokens
        return {"tokens": _meta((B, S_text), i32),
                "labels": _meta((B, S_text), i32),
                "patch_embeds": _meta((B, cfg.n_img_tokens, cfg.d_model),
                                      torch.bfloat16)}
    return {"tokens": _meta((B, S), i32), "labels": _meta((B, S), i32)}


def input_specs(cfg: ModelConfig, shape: ShapeConfig,
                dtype=torch.bfloat16) -> dict[str, Any]:
    """All inputs of the cell as ``meta`` tensors.  Keys depend on the
    kind:

    train   -> params, opt_state, batch
    prefill -> params, cache, batch (labels dropped)
    decode  -> params, cache, token, cache_len
    """
    model = build_model(cfg, device="meta")
    params = L.tree_map(lambda p: _meta(p.shape, dtype), model.spec())
    if shape.kind == "train":
        mu = L.tree_map(lambda p: _meta(p.shape, torch.float32), params)
        nu = L.tree_map(lambda p: _meta(p.shape, torch.float32), params)
        opt = {"mu": mu, "nu": nu, "step": _meta((), torch.int32)}
        return {"params": params, "opt_state": opt,
                "batch": batch_specs(cfg, shape)}

    cache = L.tree_map(lambda t: _meta(t.shape, t.dtype),
                       model.cache_spec(shape.global_batch, shape.seq_len))
    if shape.kind == "prefill":
        batch = batch_specs(cfg, shape)
        batch.pop("labels")
        return {"params": params, "cache": cache, "batch": batch}

    # decode
    return {"params": params, "cache": cache,
            "token": _meta((shape.global_batch, 1), torch.int32),
            "cache_len": _meta((), torch.int32)}


# ---------------------------------------------------------------------------
# shardings (DTensor placements)
# ---------------------------------------------------------------------------

def _shard(mesh, rules: AxisRules, axes: tuple, shape: tuple) -> tuple:
    return placements(mesh, _divisible_spec(mesh, rules.spec(axes), shape))


def _batch_shardings(mesh, rules, batch) -> dict[str, tuple]:
    return {k: _shard(mesh, rules, ("act_batch", None, None)[:v.ndim],
                      tuple(v.shape))
            for k, v in batch.items()}


def shardings_for(cfg: ModelConfig, shape: ShapeConfig, mesh,
                  rules: AxisRules, specs: dict[str, Any]) -> dict[str, Any]:
    """Placements trees matching :func:`input_specs` output."""
    model = build_model(cfg, device="meta")
    pshard = map_axes(lambda axes, t: _shard(mesh, rules, axes,
                                             tuple(t.shape)),
                      model.param_axes(), specs["params"])
    replicated = placements(mesh, ())
    out: dict[str, Any] = {"params": pshard}

    if shape.kind == "train":
        out["opt_state"] = {"mu": pshard, "nu": pshard, "step": replicated}
        out["batch"] = _batch_shardings(mesh, rules, specs["batch"])
        return out

    out["cache"] = map_axes(
        lambda axes, t: _shard(mesh, rules, axes, tuple(t.shape)),
        model.cache_axes(shape.global_batch, shape.seq_len), specs["cache"])
    if shape.kind == "prefill":
        out["batch"] = _batch_shardings(mesh, rules, specs["batch"])
    else:
        out["token"] = _shard(mesh, rules, ("act_batch", None),
                              tuple(specs["token"].shape))
        out["cache_len"] = replicated
    return out


def shard_args(cfg: ModelConfig, shape: ShapeConfig, mesh, rules: AxisRules,
               args: dict[str, Any]) -> dict[str, Any]:
    """``args`` (trees of whole tensors under :func:`input_specs`' keys) as
    DTensors laid out by :func:`shardings_for`; on a mesh of one rank each
    wraps its tensor, no copy."""
    shards = shardings_for(cfg, shape, mesh, rules, input_specs(cfg, shape))
    return {k: distribute_tree(v, mesh, shards[k]) for k, v in args.items()}


def rules_for(shape: ShapeConfig, *, multi_pod: bool) -> AxisRules:
    rules = multi_pod_rules() if multi_pod else single_pod_rules()
    if shape.kind == "decode":
        # single-token step: no sequence dim to shard
        rules = rules.with_overrides(act_seq=None)
    return rules


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
