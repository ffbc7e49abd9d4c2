"""Shared layers of the port's LM models: plain functions on tensors.

The port of ``repro/models/layers.py``.  Parameters are declared with
:class:`Pm` leaf specs (shape, logical axes, init) and held as a dict tree
of tensors with the reference's keys, shapes and stacking, so
``convert.to_torch`` carries the reference's parameters across unchanged.
:func:`init_tree` draws them from an explicit ``torch.Generator`` on the
target device.

Attention runs through the hand-written kernels, whose wrappers take their
plain versions for tensors on the CPU or on ``meta``:

* no cache (``forward``, the Scission graph's blocks): ``flash_attention``
  over the sequence;
* a cache filled from position 0 (``prefill``): the new k, v are written to
  cache rows ``[0, S)`` and ``flash_attention`` runs over them, which equals
  the reference's attention over the whole cache with ``k_len_valid = S``
  (the causal mask is aligned at position 0);
* one new token per row (``decode_step``, ragged ``cache_len``): row
  ``cache_len[b]`` of each slot is written in place and
  ``decode_attention`` reads ``cache_len + 1`` rows.

:func:`sdpa` is the reference's plain attention.  It serves the one case no
kernel takes, a prefill of several tokens at a nonzero offset, which no
entry point makes and which raises on the card.  The kernels' wrappers
choose their block sizes: the adopted tuned ones
(``kernels.substrate.serving_param``), else their defaults, halved where
the card's shared memory cannot hold the tiles.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch
import torch.nn.functional as F

from ..core.graph import TensorSpec
from ..kernels.decode_attention import decode_attention
from ..kernels.flash_attention import flash_attention


# ---------------------------------------------------------------------------
# Parameter spec trees
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Pm:
    """Parameter leaf: shape + logical axes (+ init)."""

    shape: tuple[int, ...]
    axes: tuple[str | None, ...]
    init: str = "normal"          # normal | zeros | ones
    scale: float | None = None    # None => 1/sqrt(fan_in)

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def tree_map(fn: Callable, tree: Any) -> Any:
    """``fn`` over the leaves of a tree of dicts and tuples (a spec's
    :class:`Pm` s, or tensors; the sLSTM's cache state is a tuple)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_leaves(tree: Any) -> list:
    """The leaves of a tree of dicts and tuples, dicts in sorted key order
    and tuples in positional order (the reference's pytree order)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, tuple):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def abstract_tree(spec, dtype=torch.bfloat16):
    return tree_map(lambda p: TensorSpec(p.shape, dtype), spec)


# draws larger than this many values are made in pieces of it, so that a
# stacked weight's fp32 draw never takes more than 256 MiB beside it
_DRAW = 1 << 26


def init_tree(spec, seed: int, dtype=torch.bfloat16,
              device: str | torch.device = "cuda"):
    """Parameters of ``spec`` on ``device``: normals times the leaf's scale
    (``1/sqrt(shape[0])`` unless given), zeros or ones, drawn in the
    reference's leaf order from one ``torch.Generator`` seeded by ``seed``
    on ``device``.  A ``meta`` device draws nothing."""
    dev = torch.device(device)
    gen = None if dev.type == "meta" else \
        torch.Generator(device=dev).manual_seed(seed)

    def draw(p: Pm):
        if p.init == "zeros":
            return torch.zeros(p.shape, dtype=dtype, device=dev)
        if p.init == "ones":
            return torch.ones(p.shape, dtype=dtype, device=dev)
        out = torch.empty(p.shape, dtype=dtype, device=dev)
        if gen is None:
            return out
        fan_in = p.shape[0] if p.shape else 1
        scale = p.scale if p.scale is not None else \
            1.0 / math.sqrt(max(fan_in, 1))
        for part in out.view(-1).split(_DRAW):
            part.copy_(torch.randn(part.numel(), generator=gen, device=dev)
                       .mul_(scale))
        return out

    def build(tree):
        if not isinstance(tree, dict):
            return draw(tree)
        out = {k: build(tree[k]) for k in sorted(tree)}   # the draw order
        return {k: out[k] for k in tree}

    return build(spec)


def stack_spec(spec, n: int):
    """Prepend a 'layers' stacking dim to every leaf.

    The fan-in-derived init scale is resolved *before* stacking so the extra
    leading dim does not corrupt it.
    """
    def stack(p: Pm) -> Pm:
        scale = p.scale
        if scale is None and p.init == "normal":
            scale = 1.0 / math.sqrt(max(p.shape[0] if p.shape else 1, 1))
        return Pm((n, *p.shape), ("layers", *p.axes), p.init, scale)

    return tree_map(stack, spec)


def _scalar(value: float, like: torch.Tensor) -> float:
    """``value`` rounded to ``like``'s dtype, as the reference multiplies a
    weakly typed Python scalar (a host float: no copy to the device, so a
    block that uses it can be captured in a CUDA graph)."""
    return torch.tensor(value, dtype=like.dtype).item()


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rmsnorm_spec(d: int) -> dict:
    return {"scale": Pm((d,), ("unsharded",), init="zeros")}  # (1+scale) form


def rmsnorm(p, x, eps: float = 1e-6):
    dt = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + p["scale"].float())).to(dt)


def layernorm_spec(d: int) -> dict:
    return {"scale": Pm((d,), ("unsharded",), init="ones"),
            "bias": Pm((d,), ("unsharded",), init="zeros")}


def layernorm(p, x, eps: float = 1e-5):
    dt = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"].float() + p["bias"].float()).to(dt)


def make_norm(kind: str, d: int):
    if kind == "rmsnorm":
        return rmsnorm_spec(d), rmsnorm
    if kind == "layernorm":
        return layernorm_spec(d), layernorm
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# Rotary position embedding
# ---------------------------------------------------------------------------

def rope(x, positions, theta: float = 10000.0):
    """x: (..., S, H, hd) ; positions: (..., S) broadcastable."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = torch.exp(-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device)
                      * (math.log(theta) / half))
    ang = positions[..., :, None].float() * freqs       # (..., S, half)
    cos = torch.cos(ang)[..., :, None, :]
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (GQA, sliding window, logit softcap)
# ---------------------------------------------------------------------------

def attention_spec(d_model: int, n_heads: int, n_kv: int, head_dim: int,
                   qkv_bias: bool = False) -> dict:
    spec = {
        "wq": Pm((d_model, n_heads, head_dim), ("embed", "heads", "head_dim")),
        "wk": Pm((d_model, n_kv, head_dim), ("embed", "kv_heads", "head_dim")),
        "wv": Pm((d_model, n_kv, head_dim), ("embed", "kv_heads", "head_dim")),
        "wo": Pm((n_heads, head_dim, d_model), ("heads", "head_dim", "embed")),
    }
    if qkv_bias:
        spec["bq"] = Pm((n_heads, head_dim), ("heads", "head_dim"), init="zeros")
        spec["bk"] = Pm((n_kv, head_dim), ("kv_heads", "head_dim"), init="zeros")
        spec["bv"] = Pm((n_kv, head_dim), ("kv_heads", "head_dim"), init="zeros")
    return spec


def _softcap(x, cap):
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


def _attn_mask(q_pos, k_pos, *, causal: bool, window: int | None,
               k_len_valid=None):
    """(..., Sq, Sk) boolean mask of allowed attention.

    ``k_len_valid`` may be a scalar or a per-row (B,) vector (ragged decode
    batches in the serving engine)."""
    m = torch.ones((q_pos.shape[-1], k_pos.shape[-1]), dtype=torch.bool,
                   device=q_pos.device)
    d = q_pos[..., :, None] - k_pos[..., None, :]
    if causal:
        m = m & (d >= 0)
    if window is not None:
        m = m & (d < window)
    if k_len_valid is not None:
        lv = torch.as_tensor(k_len_valid, device=q_pos.device)
        if lv.ndim == 1:
            lv = lv[:, None, None]
        m = m & (k_pos[..., None, :] < lv)
    return m


def sdpa(q, k, v, *, q_pos, k_pos, causal=True, window=None, softcap=None,
         k_len_valid=None):
    """The reference's plain scaled dot-product attention with GQA, softmax
    in fp32.  q: (B, Sq, H, hd) ; k, v: (B, Sk, Hk, hd)."""
    B, Sq, H, hd = q.shape
    G = H // k.shape[2]
    scale = 1.0 / math.sqrt(hd)
    if G > 1:
        k = k.repeat_interleave(G, dim=2)   # (B, Sk, H, hd)
        v = v.repeat_interleave(G, dim=2)
    s = torch.einsum("bchd,bshd->bhcs", q.float(), k.float()) * scale
    s = _softcap(s, softcap)
    m = _attn_mask(q_pos, k_pos, causal=causal, window=window,
                   k_len_valid=k_len_valid)
    s = torch.where(m[:, None] if m.ndim == 3 else m, s,
                    torch.tensor(-1e30, device=s.device))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhcs,bshd->bchd", p, v.float())
    return o.to(q.dtype)


def matmul(a, b):
    """``a @ b`` in the wider of their dtypes, as JAX promotes a bf16
    activation times fp32 weights (the encoder-decoder's encoder starts in
    bf16 whatever the parameters' dtype); no copy when they agree."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt) @ b.to(dt)


def _project(x, w):
    """``einsum("bsd,d...->bs...", x, w)`` as one matrix product."""
    B, S, D = x.shape
    return matmul(x.reshape(B * S, D), w.reshape(D, -1)).view(
        B, S, *w.shape[1:])


def attention(p, x, *, positions, rope_theta=10000.0, causal=True,
              window=None, softcap=None, kv_cache=None, cache_len=None,
              use_rope=True, query_pre_attn_scalar=None):
    """Full attention sub-layer: qkv proj -> rope -> attention -> out proj.

    ``kv_cache``: None, or a dict with "k", "v" of shape (B, Smax, Hk, hd),
    written in place.  ``cache_len`` is then an ``int`` (a prefill of x's S
    tokens from that offset) or a (B,) int32 tensor (one new token per
    row, decode).  Returns (out, cache).
    """
    B, S, D = x.shape
    q = _project(x, p["wq"])
    k = _project(x, p["wk"])
    v = _project(x, p["wv"])
    if "bq" in p:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    if query_pre_attn_scalar is not None:
        # gemma-style: scale q by 1/sqrt(s) instead of 1/sqrt(hd); fold in the
        # ratio so the kernels' 1/sqrt(hd) combines to 1/sqrt(s).
        hd = q.shape[-1]
        q = q * _scalar(math.sqrt(hd / query_pre_attn_scalar), q)
    if use_rope:
        q = rope(q, positions, rope_theta)
        k = rope(k, positions, rope_theta)

    if kv_cache is None:
        out = flash_attention(q, k, v, causal=causal, window=window,
                              softcap=softcap)
    elif isinstance(cache_len, int):
        ck, cv = kv_cache["k"], kv_cache["v"]
        end = cache_len + S
        ck[:, cache_len:end] = k
        cv[:, cache_len:end] = v
        if cache_len == 0:
            # causal attention aligned at position 0 over the rows just
            # written, as stored (rounded to the cache's dtype)
            k, v = ck[:, :S].to(q.dtype), cv[:, :S].to(q.dtype)
            out = flash_attention(q, k, v, causal=causal, window=window,
                                  softcap=softcap)
        elif q.device.type == "cuda":
            raise NotImplementedError(
                "a prefill of several tokens at a nonzero cache offset has "
                "no kernel on the card (ROADMAP.md Queue 2)")
        else:
            k_pos = torch.arange(ck.shape[1], device=q.device)
            out = sdpa(q, ck, cv, q_pos=positions, k_pos=k_pos,
                       causal=causal, window=window, softcap=softcap,
                       k_len_valid=end)
    else:
        if S != 1:
            raise ValueError(f"decode takes one new token per row, got {S}")
        ck, cv = kv_cache["k"], kv_cache["v"]
        # row cache_len[b] of each slot, clamped as the reference's dynamic
        # update slice clamps its start
        rows = torch.arange(B, device=x.device)
        at = cache_len.clamp(0, ck.shape[1] - 1).long()
        ck[rows, at] = k[:, 0].to(ck.dtype)
        cv[rows, at] = v[:, 0].to(cv.dtype)
        # the kernels take one dtype: a model in fp32 reads a copy of its
        # bf16 cache (bf16 models, the card's, read it as it is)
        q1, ck, cv = q[:, 0], ck.to(q.dtype), cv.to(q.dtype)
        out = decode_attention(q1, ck, cv, (cache_len + 1).to(torch.int32),
                               softcap=softcap, window=window)[:, None]

    H, hd = out.shape[2], out.shape[3]
    y = matmul(out.reshape(B * S, H * hd), p["wo"].reshape(H * hd, -1))
    return y.view(B, S, -1), kv_cache


def attention_cache_spec(cfg, batch: int, max_len: int) -> TensorSpec:
    """One layer's K (or V) cache: (batch, max_len, kv heads, head_dim) in
    bf16, as the reference keeps it."""
    return TensorSpec((batch, max_len, cfg.n_kv_heads, cfg.head_dim),
                      torch.bfloat16)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def mlp_spec(d_model: int, d_ff: int, gated: bool) -> dict:
    spec = {"w_up": Pm((d_model, d_ff), ("embed", "ff")),
            "w_down": Pm((d_ff, d_model), ("ff", "embed"))}
    if gated:
        spec["w_gate"] = Pm((d_model, d_ff), ("embed", "ff"))
    return spec


_ACTIVATIONS = {"gelu": lambda h: F.gelu(h, approximate="tanh"),
                "silu": F.silu, "relu": F.relu}


def mlp(p, x, activation: str = "gelu"):
    act = _ACTIVATIONS[activation]
    h = matmul(x, p["w_up"])
    if "w_gate" in p:
        h = act(matmul(x, p["w_gate"])) * h
    else:
        h = act(h)
    return matmul(h, p["w_down"])


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------

def embed_spec(vocab: int, d_model: int) -> dict:
    # 1/sqrt(d) keeps tied-unembedding logits O(1) after the final norm
    return {"table": Pm((vocab, d_model), ("vocab", "unsharded"),
                        scale=1.0 / math.sqrt(d_model))}


def embed(p, tokens, scale_by_dim: bool = False):
    x = F.embedding(tokens.long(), p["table"])
    if scale_by_dim:
        x = x * _scalar(math.sqrt(p["table"].shape[1]), x)
    return x


def unembed(p, x, softcap: float | None = None):
    logits = (x @ p["table"].T).float()
    return _softcap(logits, softcap)
