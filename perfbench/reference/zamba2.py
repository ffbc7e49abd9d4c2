"""Plain PyTorch reference of the published Zamba2 block, in fp32.

Zamba2 (arXiv:2411.15242; Zyphra/Zamba2-7B-Instruct's ``config.json``),
as Hugging Face's ``transformers`` states it (``Zamba2HybridLayer``,
``Zamba2AttentionDecoderLayer``, ``Zamba2MLP``, ``Zamba2MambaDecoderLayer``,
``Zamba2RMSNormGated``), one sequence at a time:

* the stack is ``n_layers`` Mamba-2 layers, ``x <- x + Mamba(norm(x + T))``,
  where ``T`` is 0 but before the layers in ``hybrid_layer_ids``;
* before the k-th of those, shared block ``k % n_shared_blocks`` runs over
  ``norm(concat(x, e))``, ``e`` the token's embedding: causal multi-head
  attention (rope over the whole head, scale ``query_pre_attn_scalar^-1/2``
  = (head_dim / 2)^-1/2) back to ``d_model``, no residual, a norm, then the
  gated MLP ``gelu(x W_g + x A_k B_g,k) * (x W_u + x A_k B_u,k) W_d``, where
  ``A_k``, ``B_k`` are application k's own LoRA; ``T`` is the MLP's output
  times application k's own ``d_model`` x ``d_model`` linear;
* the Mamba-2 mixer: one input projection to z, x, B, C (``ssm_groups``
  groups of ``ssm_state``) and dt; a depthwise causal convolution and SiLU
  over x, B, C; ``dt = softplus(dt + dt_bias)`` (no clamp: the fast path's
  ``dt_limit`` of (0, inf)); the SSD recurrence
  ``s_t = exp(dt_t a) s_{t-1} + dt_t b_t x_tᵀ``, ``y_t = c_t · s_t``, each
  head reading its group's B and C; ``y + D x``; the gated norm, RMSNorm of
  ``y * silu(z)`` over each group's channels; the output projection;
* the final norm, then the embedding table as the unembedding (tied).

Departures, in the weights' form only (the same functions): each RMSNorm
scales by ``1 + scale`` (the tree the port declares), where the published
form multiplies by a weight, the weight being ``1 + scale``; and the tree's
``dt_bias`` is the offset from Mamba-2's initial one, ``softplus^-1(dt)``
with dt log-spaced over the heads across ``ssm_dt_range`` (time_step_min,
time_step_max), so the published ``dt_bias`` is their sum.  Every norm
takes ``norm_eps`` (1e-5).

No kernel, cache or batching; TF32 off; the weights are upcast layer by
layer (the two shared blocks once).  ``fp8=True`` is the control: every
matrix product's operands and output and the residual stream between
layers are rounded to float8 (e4m3, one scale per tensor), one step below
the bf16 in which the program stores each of them.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .lm import exact_fp32, mm, rope, store, to_fp8


def _index(tree, i):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def _fp32(tree):
    if isinstance(tree, dict):
        return {k: _fp32(v) for k, v in tree.items()}
    return tree.float()


def rmsnorm(x, scale, eps):
    x = x.float()
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * (1.0 + scale.float())


def attention(p, x, cfg, fp8=False):
    """Causal multi-head attention of one sequence x: (S, D_in) -> (S,
    d_model)."""
    S = x.shape[0]
    H, Hk, hd = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    pos = torch.arange(S, device=x.device)
    q = rope(mm(x, p["wq"], fp8).view(S, H, hd), pos, cfg["rope_theta"])
    k = rope(mm(x, p["wk"], fp8).view(S, Hk, hd), pos, cfg["rope_theta"])
    v = mm(x, p["wv"], fp8).view(S, Hk, hd)
    k = k.repeat_interleave(H // Hk, dim=1)
    v = v.repeat_interleave(H // Hk, dim=1)
    s = torch.einsum("qhd,khd->hqk", q, k) \
        / math.sqrt(cfg["query_pre_attn_scalar"])
    causal = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
    s = s.masked_fill(~causal, float("-inf"))
    o = torch.einsum("hqk,khd->qhd", torch.softmax(s, dim=-1), v)
    return mm(o.reshape(S, H * hd), p["wo"], fp8)


def mlp(p, ad, x, fp8=False):
    """The shared gated MLP with application's LoRA on gate and up."""
    r = mm(x, ad["lora_a"], fp8)
    gate = mm(x, p["w_gate"], fp8) + mm(r, ad["lora_gate"], fp8)
    up = mm(x, p["w_up"], fp8) + mm(r, ad["lora_up"], fp8)
    return mm(F.gelu(gate) * up, p["w_down"], fp8)


def shared_block(p, ad, x, e, cfg, fp8=False):
    """T of one application: block ``p``, application's adapter ``ad``."""
    eps = cfg["norm_eps"]
    h = torch.cat([x, e], dim=-1)
    h = attention(p["attn"], rmsnorm(h, p["norm1"]["scale"], eps), cfg, fp8)
    h = mlp(p["mlp"], ad, rmsnorm(h, p["norm2"]["scale"], eps), fp8)
    return store(mm(h, ad["linear"], fp8), fp8)


def ssd(x, log_a, b, c, chunk):
    """The SSD recurrence from the zero state, chunk by chunk; a last
    partial chunk is padded with identity steps (x = 0, log_a = 0, b = c =
    0), whose outputs are dropped.  x: (S, H, P); log_a: (S, H); b, c:
    (S, H, N)."""
    S, H, P = x.shape
    L = min(chunk, S)
    n = -(-S // L)
    pad = n * L - S
    x, log_a, b, c = (F.pad(t, (0, 0) * (t.ndim - 1) + (0, pad))
                      for t in (x, log_a, b, c))
    x = x.reshape(n, L, H, P)
    a = log_a.reshape(n, L, H)
    b = b.reshape(n, L, H, -1)
    c = c.reshape(n, L, H, -1)
    cum = torch.cumsum(a, dim=1)                              # (n, L, H)
    seg = cum[:, :, None, :] - cum[:, None, :, :]             # (n, i, j, H)
    keep = torch.ones(L, L, dtype=torch.bool, device=x.device).tril()
    decay = torch.exp(seg.masked_fill(~keep[None, :, :, None], -math.inf))
    cb = torch.einsum("cihn,cjhn->cijh", c, b)
    y = torch.einsum("cijh,cjhp->cihp", cb * decay, x)
    to_end = torch.exp(cum[:, -1:, :] - cum)                  # (n, L, H)
    local = torch.einsum("cjhn,cjhp->chnp", b, to_end[..., None] * x)
    states, s = [], torch.zeros_like(local[0])
    for i in range(n):
        states.append(s)
        s = s * torch.exp(cum[i, -1])[:, None, None] + local[i]
    before = torch.stack(states)                              # (n, H, N, P)
    y = y + torch.exp(cum)[..., None] * torch.einsum("cihn,chnp->cihp", c,
                                                      before)
    return y.reshape(n * L, H, P)[:S]


def dt_offset(cfg, H, device):
    """Mamba-2's initial dt_bias per head, or 0 without a dt range."""
    if cfg.get("ssm_dt_range") is None:
        return 0.0
    lo, hi = (math.log(v) for v in cfg["ssm_dt_range"])
    dt = torch.exp(torch.linspace(lo, hi, H, device=device))
    return dt + torch.log(-torch.expm1(-dt))


def mamba2(p, x, cfg, fp8=False):
    """Mamba-2 mixer of one sequence x: (S, D)."""
    S = x.shape[0]
    d_inner = cfg["ssm_expand"] * cfg["d_model"]
    P, N, G = cfg["ssm_head_dim"], cfg["ssm_state"], cfg["ssm_groups"]
    H = d_inner // P
    h = mm(x, p["w_in"], fp8)
    z, xbc, dt = torch.split(h, [d_inner, d_inner + 2 * G * N, H], dim=-1)
    w = p["conv_w"].float()                                   # (K, C)
    K = w.shape[0]
    xp = torch.cat([xbc.new_zeros(K - 1, xbc.shape[1]), xbc])
    conv = sum(xp[i:i + S] * w[i] for i in range(K))
    xbc = F.silu(conv + p["conv_b"].float())
    xs, b, c = torch.split(xbc, [d_inner, G * N, G * N], dim=-1)
    b = b.reshape(S, G, N).repeat_interleave(H // G, dim=1)   # (S, H, N)
    c = c.reshape(S, G, N).repeat_interleave(H // G, dim=1)
    dt = F.softplus(dt + p["dt_bias"].float() + dt_offset(cfg, H, x.device))
    log_a = dt * -torch.exp(p["a_log"].float())
    xh = xs.view(S, H, P)
    y = ssd(xh * dt[..., None], log_a, b, c, cfg["ssm_chunk"])
    y = y + xh * p["d_skip"].float()[:, None]
    g = (y.reshape(S, d_inner) * F.silu(z)).view(S, G, d_inner // G)
    g = g * torch.rsqrt(g.square().mean(-1, keepdim=True) + cfg["norm_eps"])
    y = g.reshape(S, d_inner) * (1.0 + p["norm"]["scale"].float())
    return mm(y, p["w_out"], fp8)


@torch.no_grad()
def logits(params, cfg, seqs, fp8=False):
    """fp32 logits (S, vocab) of each token sequence in ``seqs`` (1-D
    integer tensors on the weights' device), each position predicting the
    next token."""
    eps = cfg["norm_eps"]
    apps = {gi: k for k, gi in enumerate(cfg["hybrid_layer_ids"])}
    with exact_fp32():
        table = params["embed"]["table"]
        es = [table[s.long()].float() for s in seqs]
        xs = list(es)
        blocks = [_fp32(_index(params["shared_blocks"], i))
                  for i in range(cfg["n_shared_blocks"])]
        for gi in range(cfg["n_layers"]):
            p = _fp32(_index(params["layers"], gi))["s0_mamba2"]
            ts = [None] * len(xs)
            if gi in apps:
                k = apps[gi]
                ad = _fp32(_index(params["shared_adapters"], k))
                blk = blocks[k % cfg["n_shared_blocks"]]
                ts = [shared_block(blk, ad, x, e, cfg, fp8)
                      for x, e in zip(xs, es)]
            xs = [store(x + mamba2(p["core"], rmsnorm(
                x if t is None else x + t, p["norm"]["scale"], eps), cfg,
                fp8), fp8) for x, t in zip(xs, ts)]
            del p
        tab = table.float()
        tabq = to_fp8(tab) if fp8 else tab
        out = []
        for x in xs:
            h = rmsnorm(x, params["final_norm"]["scale"], eps)
            out.append((to_fp8(h) if fp8 else h) @ tabq.T)
        return out
