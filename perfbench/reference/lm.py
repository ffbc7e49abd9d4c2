"""Plain PyTorch references of the benchmark's two configurations, in fp32.

A decoder-only LM over a repeating pattern of sub-layers, as published:

* granite-8b (arXiv:2405.04324): each layer is RMSNorm -> GQA attention
  with rotary positions -> residual, RMSNorm -> SwiGLU MLP -> residual;
  the unembedding is the embedding table (tied);
* zamba2-2.7b (arXiv:2411.15242): each layer is RMSNorm -> Mamba-2 (a
  fused input projection, a depthwise causal convolution, the SSD linear
  recurrence with one head-shared B and C, a gated RMSNorm, the output
  projection) -> residual; after every ``shared_attn_period`` layers one
  shared block (RMSNorm -> attention -> residual, RMSNorm -> gated GELU
  MLP -> residual) whose weights all applications share.

The functions read the weights from the tree the benchmark drew (the keys
the port declares, each stacked over groups of the pattern) and compute in
fp32 with TF32 off, from the weights upcast group by group.  They import
nothing of the program: no kernel, cache or batching.  RMSNorm scales by
``1 + scale`` with eps 1e-6; the MLPs' GELU is the tanh form; RoPE rotates
the two halves of each head.

``fp8=True`` is the control: every matrix product's operands and output
and the residual stream between sub-layers are rounded to float8 (e4m3
forward, their gradients e5m2 backward, one scale per tensor), one step
below the bf16 in which the program stores each of them.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

EPS = 1e-6


@contextlib.contextmanager
def exact_fp32():
    """fp32 products without TF32 for the block."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def to_fp8(t, dtype=torch.float8_e4m3fn):
    """``t`` rounded to ``dtype`` under one scale that maps its largest
    magnitude to the format's largest, back in fp32."""
    top = torch.finfo(dtype).max
    amax = t.detach().abs().amax().float().clamp_min(1e-30)
    scale = top / amax
    return (t * scale).to(dtype).float() / scale


class _Fp8Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        xq, wq = to_fp8(x), to_fp8(w)
        ctx.save_for_backward(xq, wq)
        return xq @ wq

    @staticmethod
    def backward(ctx, g):
        xq, wq = ctx.saved_tensors
        gq = to_fp8(g, torch.float8_e5m2)
        gx = gq @ wq.transpose(-1, -2)
        gw = (xq.reshape(-1, xq.shape[-1]).T
              @ gq.reshape(-1, gq.shape[-1]))
        return gx, gw


class _Fp8Round(torch.autograd.Function):
    """An activation stored in float8: e4m3 forward, its gradient e5m2
    backward."""

    @staticmethod
    def forward(ctx, x):
        return to_fp8(x)

    @staticmethod
    def backward(ctx, g):
        return to_fp8(g, torch.float8_e5m2)


def store(x, fp8: bool = False):
    """The residual stream as held between sub-layers: fp32, or float8
    for the control."""
    return _Fp8Round.apply(x) if fp8 else x


def mm(x, w, fp8: bool = False):
    """``x @ w`` over x's last axis in fp32, or through float8."""
    x = x.float()
    w = w.reshape(x.shape[-1], -1).float()
    if fp8:
        return _Fp8Round.apply(_Fp8Matmul.apply(x, w))
    return x @ w


def rmsnorm(x, scale):
    x = x.float()
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + EPS) \
        * (1.0 + scale.float())


def rope(x, positions, theta):
    """x: (S, H, hd); positions: (S,)."""
    half = x.shape[-1] // 2
    freqs = torch.exp(-torch.arange(half, dtype=torch.float32,
                                    device=x.device)
                      * (math.log(theta) / half))
    ang = positions.float()[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(p, x, cfg, fp8=False):
    """Causal attention of one sequence x: (S, D), with GQA."""
    S = x.shape[0]
    H, Hk, hd = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    pos = torch.arange(S, device=x.device)
    q = rope(mm(x, p["wq"], fp8).view(S, H, hd), pos, cfg["rope_theta"])
    k = rope(mm(x, p["wk"], fp8).view(S, Hk, hd), pos, cfg["rope_theta"])
    v = mm(x, p["wv"], fp8).view(S, Hk, hd)
    k = k.repeat_interleave(H // Hk, dim=1)
    v = v.repeat_interleave(H // Hk, dim=1)
    s = torch.einsum("qhd,khd->hqk", q, k) / math.sqrt(hd)
    causal = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
    s = s.masked_fill(~causal, float("-inf"))
    o = torch.einsum("hqk,khd->qhd", torch.softmax(s, dim=-1), v)
    return mm(o.reshape(S, H * hd), p["wo"], fp8)


ACT = {"silu": F.silu, "gelu": lambda h: F.gelu(h, approximate="tanh")}


def mlp(p, x, cfg, fp8=False):
    act = ACT[cfg["activation"]]
    return mm(act(mm(x, p["w_gate"], fp8)) * mm(x, p["w_up"], fp8),
              p["w_down"], fp8)


def ssd(x, log_a, b, c, chunk):
    """The SSD recurrence ``s_t = exp(log_a_t) s_{t-1} + b_t x_tᵀ``,
    ``y_t = c_t · s_t`` from the zero state, computed chunk by chunk.

    x: (S, H, P); log_a: (S, H); b, c: (S, N), shared by the heads."""
    S, H, P = x.shape
    L = min(chunk, S)
    if S % L:
        raise ValueError(f"sequence {S} is not a multiple of chunk {L}")
    n = S // L
    x = x.reshape(n, L, H, P)
    a = log_a.reshape(n, L, H)
    b = b.reshape(n, L, -1)
    c = c.reshape(n, L, -1)
    cum = torch.cumsum(a, dim=1)                              # (n, L, H)
    # within a chunk: y_i += sum_{j<=i} exp(cum_i - cum_j) (c_i.b_j) x_j
    seg = cum[:, :, None, :] - cum[:, None, :, :]             # (n, i, j, H)
    keep = torch.ones(L, L, dtype=torch.bool, device=x.device).tril()
    decay = torch.exp(seg.masked_fill(~keep[None, :, :, None], -math.inf))
    cb = torch.einsum("cin,cjn->cij", c, b)
    y = torch.einsum("cijh,cjhp->cihp", cb[..., None] * decay, x)
    # the state each chunk hands on, then carried across chunks
    to_end = torch.exp(cum[:, -1:, :] - cum)                  # (n, L, H)
    local = torch.einsum("cjn,cjhp->chnp", b, to_end[..., None] * x)
    states, s = [], torch.zeros_like(local[0])
    for i in range(n):
        states.append(s)
        s = s * torch.exp(cum[i, -1])[:, None, None] + local[i]
    before = torch.stack(states)                              # (n, H, N, P)
    y = y + torch.exp(cum)[..., None] * torch.einsum("cin,chnp->cihp", c,
                                                      before)
    return y.reshape(S, H, P)


def mamba2(p, x, cfg, fp8=False):
    """Mamba-2 mixer of one sequence x: (S, D)."""
    S = x.shape[0]
    d_inner = cfg["ssm_expand"] * cfg["d_model"]
    P, N = cfg["ssm_head_dim"], cfg["ssm_state"]
    H = d_inner // P
    h = mm(x, p["w_in"], fp8)
    z, xbc, dt = torch.split(h, [d_inner, d_inner + 2 * N, H], dim=-1)
    w = p["conv_w"].float()                                   # (K, C)
    K = w.shape[0]
    xp = torch.cat([xbc.new_zeros(K - 1, xbc.shape[1]), xbc])
    conv = sum(xp[i:i + S] * w[i] for i in range(K))
    xbc = F.silu(conv + p["conv_b"].float())
    xs, b, c = torch.split(xbc, [d_inner, N, N], dim=-1)
    dt = F.softplus(dt + p["dt_bias"].float())                # (S, H)
    log_a = dt * -torch.exp(p["a_log"].float())
    xh = xs.view(S, H, P)
    y = ssd(xh * dt[..., None], log_a, b, c, cfg["ssm_chunk"])
    y = y + xh * p["d_skip"].float()[:, None]
    y = rmsnorm(y.reshape(S, d_inner), p["norm"]["scale"]) * F.silu(z)
    return mm(y, p["w_out"], fp8)


def _kinds(cfg):
    kinds = [k for layer in cfg["pattern"] for k in layer]
    if cfg.get("shared_attn_period"):
        kinds = kinds * cfg["shared_attn_period"]
    return kinds


def n_groups(cfg) -> int:
    if cfg.get("shared_attn_period"):
        return cfg["n_layers"] // cfg["shared_attn_period"]
    return cfg["n_layers"] // len(cfg["pattern"])


def _index(tree, g):
    if isinstance(tree, dict):
        return {k: _index(v, g) for k, v in tree.items()}
    return tree[g]


def group(params_g, shared, x, cfg, fp8=False):
    """One repetition of the pattern (and the shared block) over x:
    (S, D) in fp32."""
    for i, kind in enumerate(_kinds(cfg)):
        p = params_g[f"s{i}_{kind}"]
        if kind == "attn":
            x = x + attention(p["attn"], rmsnorm(x, p["norm"]["scale"]),
                              cfg, fp8)
        elif kind == "mlp":
            x = x + mlp(p["mlp"], rmsnorm(x, p["norm"]["scale"]), cfg, fp8)
        elif kind == "mamba2":
            x = x + mamba2(p["core"], rmsnorm(x, p["norm"]["scale"]),
                           cfg, fp8)
        else:
            raise ValueError(f"the reference has no sub-layer {kind!r}")
        x = store(x, fp8)
    if shared is not None:
        x = store(x + attention(shared["attn"],
                                rmsnorm(x, shared["norm1"]["scale"]),
                                cfg, fp8), fp8)
        x = store(x + mlp(shared["mlp"],
                          rmsnorm(x, shared["norm2"]["scale"]), cfg, fp8),
                  fp8)
    return x


def _fp32(tree):
    if isinstance(tree, dict):
        return {k: _fp32(v) for k, v in tree.items()}
    return tree.float()


@torch.no_grad()
def logits(params, cfg, seqs, fp8=False):
    """fp32 logits (S, vocab) of each token sequence in ``seqs`` (1-D
    integer tensors on the weights' device), each position predicting the
    next token.  The weights are upcast one group at a time."""
    with exact_fp32():
        table = params["embed"]["table"]
        xs = [table[s.long()].float() for s in seqs]
        shared = params.get("shared_block")
        shared = None if shared is None else _fp32(shared)
        for g in range(n_groups(cfg)):
            pg = _fp32(_index(params["layers"], g))
            xs = [group(pg, shared, x, cfg, fp8) for x in xs]
            del pg
        tab = table.float()
        tabq = to_fp8(tab) if fp8 else tab
        out = []
        for x in xs:
            h = rmsnorm(x, params["final_norm"]["scale"])
            out.append((to_fp8(h) if fp8 else h) @ tabq.T)
        return out


def loss(params, cfg, tokens, labels, fp8=False, remat=True):
    """Mean next-token cross-entropy over the valid labels of a batch
    ((B, S) ``tokens`` and ``labels``; label -1 is ignored), differentiable
    in ``params`` (fp32 leaves).  Each group runs under
    ``torch.utils.checkpoint`` when ``remat``, so that the fp32 activations
    of a 4096-token sequence fit."""
    table = params["embed"]["table"]
    shared = params.get("shared_block")
    total = 0.0
    for row, lab in zip(tokens, labels):
        x = table[row.long()]
        for g in range(n_groups(cfg)):
            pg = _index(params["layers"], g)
            if remat:
                x = checkpoint(group, pg, shared, x, cfg, fp8,
                               use_reentrant=False)
            else:
                x = group(pg, shared, x, cfg, fp8)
        h = rmsnorm(x, params["final_norm"]["scale"])
        z = _Fp8Matmul.apply(h, table.T) if fp8 else h @ table.T
        nll = torch.logsumexp(z, -1) - z.gather(
            -1, lab.clamp(min=0).long()[:, None])[:, 0]
        total = total + torch.where(lab >= 0, nll, 0.0).sum()
    return total / (labels >= 0).sum().clamp(min=1)
