"""Generic decoder-only LM over per-layer sub-layer patterns: the port of
``repro/models/lm.py``.

The config's ``pattern`` lists each layer's sub-layer kinds; the stack is a
Python loop over *groups* (one pattern repetition) whose parameters are
stacked along a leading axis, as the reference's ``lax.scan`` carries them.
zamba2-style shared blocks live outside the stack and are applied once per
group.  Caches are preallocated stacked tensors ``(G, B, ...)`` that the
steps write in place (and return).

Execution modes:
* ``forward``      — full-sequence pass, no cache,
* ``prefill``      — full sequence from position 0, fills the caches,
* ``decode_step``  — one token per row against the caches.

``aux`` is the MoE layers' Switch load-balancing loss summed over the
stack (0.0 without MoE layers).  The sLSTM's state starts differently by
entry point, as in the reference: ``forward`` passes none (its stabiliser
starts at -1e9), ``prefill`` the zeroed cache (0).
"""

from __future__ import annotations

import torch

from .._device import resolve_device
from ..core.graph import TensorSpec
from . import layers as L
from .moe import moe, moe_spec
from .ssm import mamba2, mamba2_spec, mamba2_state_specs
from .xlstm import (mlstm, mlstm_spec, mlstm_state_specs, slstm, slstm_spec,
                    slstm_state_specs)

KINDS = frozenset({"attn", "attn_local", "mlp", "moe", "mamba2", "mlstm",
                   "slstm"})


# ---------------------------------------------------------------------------
# Per-sub-layer specs and application
# ---------------------------------------------------------------------------

def _sub_spec(cfg, kind: str) -> dict:
    norm_spec, _ = L.make_norm(cfg.norm, cfg.d_model)
    if kind in ("attn", "attn_local"):
        s = {"norm": norm_spec,
             "attn": L.attention_spec(cfg.d_model, cfg.n_heads,
                                      cfg.n_kv_heads, cfg.head_dim,
                                      qkv_bias=cfg.qkv_bias)}
        if cfg.post_block_norm:
            s["post_norm"] = norm_spec
        return s
    if kind == "mlp":
        s = {"norm": norm_spec,
             "mlp": L.mlp_spec(cfg.d_model, cfg.d_ff, gated=cfg.mlp_gated)}
        if cfg.post_block_norm:
            s["post_norm"] = norm_spec
        return s
    if kind == "moe":
        return {"norm": norm_spec,
                "moe": moe_spec(cfg.d_model, cfg.d_ff, cfg.moe_experts,
                                n_shared=1 if cfg.moe_shared_dff else 0,
                                d_shared=cfg.moe_shared_dff)}
    if kind == "mamba2":
        return {"norm": norm_spec, "core": mamba2_spec(cfg)}
    if kind == "mlstm":
        return {"norm": norm_spec, "core": mlstm_spec(cfg)}
    if kind == "slstm":
        return {"core": slstm_spec(cfg)}
    raise ValueError(kind)


def _norm(cfg):
    return L.rmsnorm if cfg.norm == "rmsnorm" else L.layernorm


def apply_sublayer(cfg, kind, p, x, *, positions, cache, cache_len, mode):
    """Returns (x, cache, aux); a cache is written in place."""
    normf = _norm(cfg)

    if kind in ("attn", "attn_local"):
        h = normf(p["norm"], x)
        window = cfg.window if kind == "attn_local" else None
        h, cache = L.attention(
            p["attn"], h, positions=positions, rope_theta=cfg.rope_theta,
            causal=True, window=window, softcap=cfg.attn_softcap,
            kv_cache=cache, cache_len=cache_len, use_rope=cfg.use_rope,
            query_pre_attn_scalar=cfg.query_pre_attn_scalar)
        if cfg.post_block_norm:
            h = normf(p["post_norm"], h)
        return x + h, cache, 0.0

    if kind == "mlp":
        h = normf(p["norm"], x)
        h = L.mlp(p["mlp"], h, activation=cfg.activation)
        if cfg.post_block_norm:
            h = normf(p["post_norm"], h)
        return x + h, None, 0.0

    if kind == "moe":
        h = normf(p["norm"], x)
        h, aux = moe(p["moe"], h, top_k=cfg.moe_top_k,
                     n_experts=cfg.moe_experts,
                     capacity_factor=cfg.moe_capacity_factor,
                     activation=cfg.activation,
                     group_size=cfg.moe_group_size, impl=cfg.moe_impl)
        return x + h, None, aux

    # a prefill from offset 0 starts from the zero state: passing none
    # skips an SSD initial state's terms, which add zeros
    fresh = mode == "prefill" and isinstance(cache_len, int) and \
        cache_len == 0
    if kind in ("mamba2", "mlstm"):
        h = normf(p["norm"], x)
        core, key = (mamba2, "ssm") if kind == "mamba2" else (mlstm, "mat")
        st = {} if fresh or cache is None else cache
        h, (ssm_st, conv_st) = core(p["core"], cfg, h, state=st.get(key),
                                    conv_state=st.get("conv"),
                                    decode=(mode == "decode"))
        if cache is not None and mode != "train":
            cache[key].copy_(ssm_st)
            cache["conv"].copy_(conv_st)
        return x + h, cache, 0.0

    if kind == "slstm":
        # the state is passed even from a zeroed cache: its stabiliser then
        # starts at 0, not at forward's -1e9 (the reference's semantics)
        x, new_st = slstm(p["core"], cfg, x,
                          state=None if cache is None else cache["s"],
                          decode=(mode == "decode"))
        if cache is not None and mode != "train":
            for dst, src in zip(cache["s"], new_st):
                dst.copy_(src)
        return x, cache, 0.0

    raise ValueError(kind)


def _sub_cache_spec(cfg, kind: str, batch: int, max_len: int):
    """TensorSpec tree of one sub-layer's cache."""
    if kind in ("attn", "attn_local"):
        kv = L.attention_cache_spec(cfg, batch, max_len)
        return {"k": kv, "v": kv}
    if kind == "mamba2":
        ssm, conv = mamba2_state_specs(cfg, batch)
        return {"ssm": ssm, "conv": conv}
    if kind == "mlstm":
        mat, conv = mlstm_state_specs(cfg, batch)
        return {"mat": mat, "conv": conv}
    if kind == "slstm":
        return {"s": slstm_state_specs(cfg, batch)}
    return None


def _index(tree, i: int):
    """Entry ``i`` of every stacked leaf (views)."""
    return L.tree_map(lambda a: a[i], tree)


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------

class DecoderLM:
    """The LM of ``cfg`` on ``device`` (the card unless the caller asks for
    the CPU): :meth:`init` draws its parameters there and
    :meth:`init_cache` allocates its caches there."""

    def __init__(self, cfg, device: str | torch.device = "cuda"):
        self.cfg = cfg
        self.kinds = list(cfg.group_kinds)
        unknown = sorted(set(self.kinds) - KINDS)
        if unknown:
            raise ValueError(f"{cfg.name}: unknown sub-layer kinds {unknown}")
        self.sub_names = [f"s{i}_{k}" for i, k in enumerate(self.kinds)]
        self.device = resolve_device(device)

    # -- parameter trees ----------------------------------------------------
    def group_spec(self) -> dict:
        return {n: _sub_spec(self.cfg, k)
                for n, k in zip(self.sub_names, self.kinds)}

    def spec(self) -> dict:
        cfg = self.cfg
        norm_spec, _ = L.make_norm(cfg.norm, cfg.d_model)
        spec = {
            "embed": L.embed_spec(cfg.vocab, cfg.d_model),
            "final_norm": norm_spec,
            "layers": L.stack_spec(self.group_spec(), cfg.n_groups),
        }
        if cfg.shared_attn_period:
            spec["shared_block"] = {
                "norm1": norm_spec,
                "attn": L.attention_spec(cfg.d_model, cfg.n_heads,
                                         cfg.n_kv_heads, cfg.head_dim),
                "norm2": norm_spec,
                "mlp": L.mlp_spec(cfg.d_model, cfg.d_ff, gated=cfg.mlp_gated),
            }
        return spec

    def init(self, seed: int = 0, dtype=torch.bfloat16):
        return L.init_tree(self.spec(), seed, dtype, self.device)

    def abstract_params(self, dtype=torch.bfloat16):
        return L.abstract_tree(self.spec(), dtype)

    # -- caches ---------------------------------------------------------------
    def cache_spec(self, batch: int, max_len: int) -> dict:
        """Stacked (G, ...) decode-cache specs: {name: {leaf: TensorSpec}}."""
        cfg = self.cfg
        out = {}
        for n, k in zip(self.sub_names, self.kinds):
            sub = _sub_cache_spec(cfg, k, batch, max_len)
            if sub is not None:
                out[n] = L.tree_map(
                    lambda t: TensorSpec((cfg.n_groups, *t.shape), t.dtype),
                    sub)
        if cfg.shared_attn_period:
            kv = L.attention_cache_spec(cfg, batch, max_len)
            stacked = TensorSpec((cfg.n_groups, *kv.shape), kv.dtype)
            out["shared_attn"] = {"k": stacked, "v": stacked}
        return out

    def init_cache(self, batch: int, max_len: int):
        return L.tree_map(
            lambda t: torch.zeros(t.shape, dtype=t.dtype, device=self.device),
            self.cache_spec(batch, max_len))

    # -- stack ---------------------------------------------------------------
    def _apply_group(self, params_g, shared, x, cache_g, *, positions,
                     cache_len, mode):
        aux = 0.0
        for n, k in zip(self.sub_names, self.kinds):
            c = cache_g.get(n) if cache_g else None
            x, _, a = apply_sublayer(self.cfg, k, params_g[n], x,
                                     positions=positions, cache=c,
                                     cache_len=cache_len, mode=mode)
            aux = aux + a
        if shared is not None:
            normf = _norm(self.cfg)
            h = normf(shared["norm1"], x)
            c = cache_g.get("shared_attn") if cache_g else None
            h, _ = L.attention(shared["attn"], h, positions=positions,
                               rope_theta=self.cfg.rope_theta, causal=True,
                               kv_cache=c, cache_len=cache_len)
            x = x + h
            h = normf(shared["norm2"], x)
            x = x + L.mlp(shared["mlp"], h, activation=self.cfg.activation)
        return x, cache_g, aux

    def _stack(self, params, x, caches, *, positions, cache_len, mode):
        shared = params.get("shared_block")
        aux = 0.0
        for gi in range(self.cfg.n_groups):
            cg = None if caches is None else _index(caches, gi)
            x, _, a = self._apply_group(_index(params["layers"], gi), shared,
                                        x, cg, positions=positions,
                                        cache_len=cache_len, mode=mode)
            aux = aux + a
        return x, caches, aux

    # -- entry points ---------------------------------------------------------
    def _embed_inputs(self, params, tokens, patch_embeds=None):
        x = L.embed(params["embed"], tokens,
                    scale_by_dim=self.cfg.embed_scale)
        if patch_embeds is not None:
            x = torch.cat([patch_embeds.to(x.dtype), x], dim=1)
        return x

    def forward(self, params, tokens, patch_embeds=None):
        """Full-sequence pass -> (final hidden states, aux): the MoE
        layers' load-balancing loss, summed."""
        x = self._embed_inputs(params, tokens, patch_embeds)
        positions = torch.arange(x.shape[1], dtype=torch.int32,
                                 device=x.device)[None, :]
        x, _, aux = self._stack(params, x, None, positions=positions,
                                cache_len=None, mode="train")
        return _norm(self.cfg)(params["final_norm"], x), aux

    def prefill(self, params, tokens, cache, patch_embeds=None):
        """Fill caches with the prompt from position 0, recurrent states
        from the (zeroed) cache; returns (last_logits, caches)."""
        x = self._embed_inputs(params, tokens, patch_embeds)
        positions = torch.arange(x.shape[1], dtype=torch.int32,
                                 device=x.device)[None, :]
        x, caches, _ = self._stack(params, x, cache, positions=positions,
                                   cache_len=0, mode="prefill")
        hidden = _norm(self.cfg)(params["final_norm"], x[:, -1:])
        logits = L.unembed(params["embed"], hidden,
                           softcap=self.cfg.final_softcap)
        return logits, caches

    def decode_step(self, params, token, cache, cache_len):
        """token: (B, 1) int32; cache_len: filled length — scalar for
        uniform decode or (B,) for ragged serving batches."""
        x = self._embed_inputs(params, token)
        clen = torch.as_tensor(cache_len, dtype=torch.int32,
                               device=x.device)
        if clen.ndim == 0:
            clen = clen.expand(x.shape[0])
        x, caches, _ = self._stack(params, x, cache, positions=clen[:, None],
                                   cache_len=clen, mode="decode")
        hidden = _norm(self.cfg)(params["final_norm"], x)
        logits = L.unembed(params["embed"], hidden,
                           softcap=self.cfg.final_softcap)
        return logits, caches
