"""Whisper-style encoder-decoder backbone: the port of
``repro/models/encdec.py``.

The conv/mel frontend is a stub, as in the reference: the caller supplies
precomputed frame embeddings (B, encoder_len, d_model).  After them come
sinusoidal positions, a bidirectional encoder, a causal decoder with
cross-attention, and the tied unembedding.

Every attention runs through the hand-written kernels (their plain
versions on the CPU), as ``layers.attention`` routes them:

* encoder self-attention: ``flash_attention`` with ``causal=False`` over
  the frames;
* decoder self-attention: ``flash_attention`` in prefill (and without a
  cache), ``decode_attention`` in decode;
* cross-attention, which the reference computes with its plain ``sdpa``
  and no mask: ``flash_attention`` with ``causal=False`` over the encoder
  memory (Sq = the prompt, Sk = ``encoder_len``) in prefill, and
  ``decode_attention`` over the cross cache with every row's length
  ``encoder_len`` in decode.

As in the reference, ``encode`` casts the frames and the sinusoidal table
to bf16 whatever the parameters' dtype, the cross K/V cache is stored in
bf16, and decode offsets the positions per row.  Caches are preallocated
stacked ``(G, B, ...)`` tensors the steps write in place.  With
``cfg.remat`` each encoder and decoder layer runs under
``torch.utils.checkpoint`` when autograd records the pass.
"""

from __future__ import annotations

import math

import torch

from .._device import resolve_device
from ..core.graph import TensorSpec
from ..kernels.decode_attention import decode_attention
from ..kernels.flash_attention import flash_attention
from ..runtime.sharding import constrain, flatten, unflatten
from . import layers as L
from .lm import _index


def sinusoidal(S: int, D: int, offset=0, device=None) -> torch.Tensor:
    """(S, D) table, or (B, S, D) when ``offset`` is a per-row vector.  A
    Python ``offset`` stays on the host (no copy to the device, so a block
    that uses it can be captured in a CUDA graph)."""
    if isinstance(offset, torch.Tensor):
        device, offset = offset.device, offset.float()
    pos = torch.arange(S, dtype=torch.float32, device=device)
    if isinstance(offset, torch.Tensor) and offset.ndim == 1:
        pos = offset[:, None] + pos[None, :]
    else:
        pos = pos + offset
    half = D // 2
    freq = torch.exp(-math.log(10000.0)
                     * torch.arange(half, dtype=torch.float32,
                                    device=device) / max(half - 1, 1))
    ang = pos[..., None] * freq
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


class EncDecLM:
    """The encoder-decoder of ``cfg`` on ``device`` (the card unless the
    caller asks for the CPU), with ``DecoderLM``'s entry points:
    ``forward`` (teacher-forced, no cache), ``prefill`` and
    ``decode_step``."""

    def __init__(self, cfg, device: str | torch.device = "cuda"):
        assert cfg.is_encdec
        self.cfg = cfg
        self.device = resolve_device(device)

    # -- specs ----------------------------------------------------------------
    def _enc_group_spec(self):
        cfg = self.cfg
        norm_spec, _ = L.make_norm(cfg.norm, cfg.d_model)
        return {
            "attn_norm": norm_spec,
            "attn": L.attention_spec(cfg.d_model, cfg.n_heads,
                                     cfg.n_kv_heads, cfg.head_dim,
                                     qkv_bias=cfg.qkv_bias),
            "mlp_norm": norm_spec,
            "mlp": L.mlp_spec(cfg.d_model, cfg.d_ff, gated=cfg.mlp_gated),
        }

    def _dec_group_spec(self):
        cfg = self.cfg
        norm_spec, _ = L.make_norm(cfg.norm, cfg.d_model)
        attn = L.attention_spec(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                                cfg.head_dim, qkv_bias=cfg.qkv_bias)
        return {
            "self_norm": norm_spec,
            "self_attn": attn,
            "cross_norm": norm_spec,
            "cross_attn": attn,
            "mlp_norm": norm_spec,
            "mlp": L.mlp_spec(cfg.d_model, cfg.d_ff, gated=cfg.mlp_gated),
        }

    def spec(self):
        cfg = self.cfg
        norm_spec, _ = L.make_norm(cfg.norm, cfg.d_model)
        return {
            "embed": L.embed_spec(cfg.vocab, cfg.d_model),
            "encoder": L.stack_spec(self._enc_group_spec(),
                                    cfg.encoder_layers),
            "enc_final_norm": norm_spec,
            "decoder": L.stack_spec(self._dec_group_spec(), cfg.n_layers),
            "final_norm": norm_spec,
        }

    def init(self, seed: int = 0, dtype=torch.bfloat16):
        return L.init_tree(self.spec(), seed, dtype, self.device)

    def abstract_params(self, dtype=torch.bfloat16):
        return L.abstract_tree(self.spec(), dtype)

    def param_axes(self):
        return L.axes_tree(self.spec())

    def _normf(self):
        return L.rmsnorm if self.cfg.norm == "rmsnorm" else L.layernorm

    # -- encoder ----------------------------------------------------------------
    def encoder_layer(self, pg, x):
        """One encoder layer: non-causal self-attention, then the MLP."""
        cfg, normf = self.cfg, self._normf()
        positions = torch.arange(x.shape[1], dtype=torch.int32,
                                 device=x.device)[None, :]
        h, _ = L.attention(pg["attn"], normf(pg["attn_norm"], x),
                           positions=positions, causal=False, use_rope=False)
        x = x + h
        return x + L.mlp(pg["mlp"], normf(pg["mlp_norm"], x),
                         activation=cfg.activation)

    def encode(self, params, frames):
        # frames and the sinusoidal table in bf16, whatever the params' dtype
        x = frames.to(torch.bfloat16) + sinusoidal(
            frames.shape[1], self.cfg.d_model,
            device=frames.device).to(torch.bfloat16)[None]
        x = constrain(x, "act_batch", "act_seq", None)
        layer = self.encoder_layer
        if self.cfg.remat and L.grad_needed(params["encoder"]):
            layer = L.remat(layer)
        for gi in range(self.cfg.encoder_layers):
            x = layer(_index(params["encoder"], gi), x)
        return self._normf()(params["enc_final_norm"], x)

    # -- decoder ----------------------------------------------------------------
    def _cross_attend(self, pg, h, memory=None, mem_kv=None):
        """Cross-attention: q from h, k/v from the encoder memory (or, in
        decode, the cross cache).  Returns (y, (k, v))."""
        B, S, _ = h.shape
        p = pg["cross_attn"]
        q = L._project(h, p["wq"])
        if "bq" in p:
            q = q + p["bq"]
        if mem_kv is None:
            k = L._project(memory, p["wk"])
            v = L._project(memory, p["wv"])
            if "bk" in p:
                k = k + p["bk"]
                v = v + p["bv"]
            # no mask: every query sees every frame
            out = flash_attention(q, k, v, causal=False)
        else:
            k, v = mem_kv["xk"], mem_kv["xv"]
            if S != 1:
                raise ValueError(f"decode takes one new token per row, got "
                                 f"{S}")
            lengths = torch.full((B,), k.shape[1], dtype=torch.int32,
                                 device=h.device)
            out = decode_attention(q[:, 0], k.to(q.dtype), v.to(q.dtype),
                                   lengths)[:, None]
        H, hd = out.shape[2], out.shape[3]
        y = L.matmul(flatten(flatten(out, 2, 3), 0, 1),
                     p["wo"].reshape(H * hd, -1))
        y = constrain(unflatten(y, 0, (B, S)), "act_batch", "act_seq", None)
        return y, (k, v)

    def decoder_layer(self, pg, x, memory, cache_g, *, positions, cache_len,
                      mode):
        """One decoder layer; in prefill it writes the layer's self and
        cross caches (``cache_g``) in place, in decode it reads them."""
        normf = self._normf()
        h, _ = L.attention(pg["self_attn"], normf(pg["self_norm"], x),
                           positions=positions, causal=True, use_rope=False,
                           kv_cache=None if cache_g is None
                           else cache_g["self"], cache_len=cache_len)
        x = x + h
        cross = cache_g["cross"] if cache_g is not None and \
            mode == "decode" else None
        h, (k, v) = self._cross_attend(pg, normf(pg["cross_norm"], x),
                                       memory=memory, mem_kv=cross)
        if cache_g is not None and mode == "prefill":
            cache_g["cross"]["xk"].copy_(k)
            cache_g["cross"]["xv"].copy_(v)
        x = x + h
        return x + L.mlp(pg["mlp"], normf(pg["mlp_norm"], x),
                         activation=self.cfg.activation)

    def _decoder_stack(self, params, x, memory, caches, *, positions,
                       cache_len, mode):
        layer = self.decoder_layer
        if self.cfg.remat and L.grad_needed(params["decoder"], x, memory):
            layer = L.remat(layer)
        for gi in range(self.cfg.n_layers):
            x = layer(
                _index(params["decoder"], gi), x, memory,
                None if caches is None else _index(caches, gi),
                positions=positions, cache_len=cache_len, mode=mode)
        return x, caches

    # -- entry points -------------------------------------------------------
    def _embed_tokens(self, params, tokens, offset):
        x = L.embed(params["embed"], tokens)
        pe = sinusoidal(tokens.shape[1], self.cfg.d_model, offset=offset,
                        device=x.device).to(x.dtype)
        x = x + (pe if pe.ndim == 3 else pe[None])
        return constrain(x, "act_batch", "act_seq", None)

    def forward(self, params, tokens, frames):
        """Teacher-forced pass (the reference's ``loss`` without its
        cross-entropy) -> (final hidden states, aux 0.0)."""
        memory = self.encode(params, frames)
        x = self._embed_tokens(params, tokens, 0)
        positions = torch.arange(x.shape[1], dtype=torch.int32,
                                 device=x.device)[None, :]
        x, _ = self._decoder_stack(params, x, memory, None,
                                   positions=positions, cache_len=None,
                                   mode="train")
        return self._normf()(params["final_norm"], x), 0.0

    def loss(self, params, batch):
        """batch: {"tokens", "labels": (B, S), "frames": (B, T, D)} ->
        (nll, {"nll", "aux": 0})."""
        hidden, _ = self.forward(params, batch["tokens"], batch["frames"])
        nll = L.cross_entropy_loss(params["embed"], hidden, batch["labels"],
                                   seq_chunk=self.cfg.loss_seq_chunk)
        return nll, {"nll": nll, "aux": nll.new_zeros(())}

    def cache_spec(self, batch: int, max_len: int) -> dict:
        """Stacked (G, ...) specs: self K/V (B, max_len, Hk, hd) and cross
        K/V (B, encoder_len, Hk, hd), all bf16, as the reference keeps
        them."""
        cfg = self.cfg
        kv = L.attention_cache_spec(cfg, batch, max_len)
        xs = TensorSpec((batch, cfg.encoder_len, cfg.n_kv_heads,
                         cfg.head_dim), torch.bfloat16)
        G = cfg.n_layers

        def stack(t):
            return TensorSpec((G, *t.shape), t.dtype)

        return {"self": {"k": stack(kv), "v": stack(kv)},
                "cross": {"xk": stack(xs), "xv": stack(xs)}}

    def cache_axes(self, batch: int, max_len: int) -> dict:
        """The logical axes of :meth:`cache_spec`'s leaves, the
        reference's."""
        kv = ("layers", *L.attention_cache_axes(self.cfg))
        xs = ("layers", "act_batch", None, "act_heads", None)
        return {"self": {"k": kv, "v": kv}, "cross": {"xk": xs, "xv": xs}}

    def init_cache(self, batch: int, max_len: int):
        return L.tree_map(
            lambda t: torch.zeros(t.shape, dtype=t.dtype, device=self.device),
            self.cache_spec(batch, max_len))

    def prefill(self, params, tokens, cache, frames=None):
        """Encode the frames, fill the caches with the prompt from position
        0; returns (last_logits, caches)."""
        memory = self.encode(params, frames)
        x = self._embed_tokens(params, tokens, 0)
        positions = torch.arange(x.shape[1], dtype=torch.int32,
                                 device=x.device)[None, :]
        x, caches = self._decoder_stack(params, x, memory, cache,
                                        positions=positions, cache_len=0,
                                        mode="prefill")
        hidden = self._normf()(params["final_norm"], x[:, -1:])
        return L.unembed(params["embed"], hidden), caches

    def decode_step(self, params, token, cache, cache_len):
        """token: (B, 1) int32; cache_len: filled length, scalar or (B,)."""
        clen = torch.as_tensor(cache_len, dtype=torch.int32,
                               device=token.device)
        if clen.ndim == 0:
            clen = clen.expand(token.shape[0])
        x = self._embed_tokens(params, token, clen)
        x, caches = self._decoder_stack(params, x, None, cache,
                                        positions=clen[:, None],
                                        cache_len=clen, mode="decode")
        hidden = self._normf()(params["final_norm"], x)
        return L.unembed(params["embed"], hidden), caches
