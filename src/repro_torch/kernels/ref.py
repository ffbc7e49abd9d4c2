"""Plain PyTorch versions of the hand-written kernels.

Each repeats its kernel's arithmetic in float32 with whole-tensor ops: the
wrappers in ``flash_attention.py`` / ``decode_attention.py`` /
``ssd_scan.py`` call them for tensors on the CPU (the tests) and on ``meta``
(shape tracing), and ``chip_smoke.py`` holds each CUDA kernel against them
on the card.  They define the kernels' semantics where those differ from
the TPU package's oracles: a fully masked attention row (a decode row with
``length == 0`` included) gives zeros, not NaN.
"""

from __future__ import annotations

import math

import torch

from .substrate import pad_axis_to, round_up


def _softmax(s):
    """Softmax over the last axis of masked (-inf) scores; a row with every
    entry masked gives zeros (the kernels' l == 0 case), not NaN."""
    m = s.amax(dim=-1, keepdim=True).clamp_min(torch.finfo(torch.float32).min)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    return p / torch.where(l == 0, torch.ones_like(l), l)


def flash_attention_ref(q, k, v, *, causal=True, window=None, softcap=None):
    """q: (B, Sq, H, hd); k, v: (B, Sk, Hk, hd) with H % Hk == 0.

    Causal masking aligns query and key position 0 (``qpos >= kpos``).
    Returns (B, Sq, H, hd) in q's dtype.
    """
    B, Sq, H, hd = q.shape
    Sk, Hk = k.shape[1], k.shape[2]
    G = H // Hk
    scale = 1.0 / math.sqrt(hd)
    qf = q.float().reshape(B, Sq, Hk, G, hd)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float()) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    qpos = torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos >= kpos
    if window is not None:
        mask &= qpos - kpos < window
    p = _softmax(s.masked_fill(~mask, -math.inf))
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return o.reshape(B, Sq, H, hd).to(q.dtype)


def decode_attention_ref(q, k, v, lengths, *, softcap=None, window=None,
                         starts=None, return_lse=False):
    """One new token per sequence against a KV cache.

    q: (B, H, hd); k, v: (B, Smax, Hk, hd) with H % Hk == 0; lengths: (B,)
    int32, the valid cache entries of each row (keys at ``kpos < length``).
    With a ``window``, keys at ``kpos < length - window`` are masked too:
    the new token, at position ``length - 1``, sees the ``window`` keys up
    to itself, as a sliding-window layer masks decode.  With ``starts``
    ((B,) int32), keys at ``kpos < starts[b]`` are masked too: a rank's
    slice of a cache split on its sequence.  Query head h reads kv head
    ``h // (H // Hk)``.  Returns (B, H, hd) in q's dtype; a row with no
    valid key gives zeros.  With ``return_lse`` also each row's
    log-sum-exp of its scaled (softcapped) valid scores, (B, H) fp32, -inf
    for a row with no valid key: what :func:`combine_partials` needs.
    """
    B, H, hd = q.shape
    Smax, Hk = k.shape[1], k.shape[2]
    G = H // Hk
    scale = 1.0 / math.sqrt(hd)
    qf = q.float().reshape(B, Hk, G, hd)
    s = torch.einsum("bhgd,bkhd->bhgk", qf, k.float()) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    kpos = torch.arange(Smax, device=q.device)
    lengths = lengths.to(q.device)[:, None]
    mask = kpos[None, :] < lengths                                # (B, Smax)
    if window is not None:
        mask &= kpos[None, :] >= lengths - window
    if starts is not None:
        mask &= kpos[None, :] >= starts.to(q.device)[:, None]
    s = s.masked_fill(~mask[:, None, None, :], -math.inf)
    o = torch.einsum("bhgk,bkhd->bhgd", _softmax(s), v.float())
    o = o.reshape(B, H, hd).to(q.dtype)
    if not return_lse:
        return o
    return o, torch.logsumexp(s, dim=-1).reshape(B, H)


def combine_weights(lse, M):
    """``exp(lse - M)``: each partial's weight against the rows' largest
    log-sum-exp ``M``; 0 for a partial with no valid key, and for every
    partial of a row whose ``M`` is -inf (never (-inf) - (-inf))."""
    return torch.exp(lse - M.clamp_min(torch.finfo(torch.float32).min))


def combine_partials(o, lse):
    """Decode attention over a cache cut on its sequence into R slices,
    from each slice's output and log-sum-exp (what the reference leaves to
    XLA across ranks, ``repro/kernels/decode_attention.py:8-10``).

    o: (R, B, H, hd), the slices' outputs; lse: (R, B, H) fp32.  With
    ``M = max_r lse_r`` and ``w_r = exp(lse_r - M)``, returns ``sum_r w_r
    o_r / sum_r w_r`` computed in fp32, (B, H, hd) in o's dtype; a row
    whose every slice holds no valid key gives zeros, not NaN.
    """
    w = combine_weights(lse, lse.amax(dim=0))[..., None]    # (R, B, H, 1)
    return merge_weighted((w * o.float()).sum(dim=0), w.sum(dim=0), o.dtype)


def merge_weighted(num, den, dtype):
    """``num / den`` in ``dtype``: the weighted outputs' sum over their
    weights' (fp32), zeros where the weights sum to 0."""
    return (num / torch.where(den == 0, torch.ones_like(den), den)).to(dtype)


def heads_of(t, H: int):
    """(B, S, G, N) maps of G groups as (B, S, H, N), one per head (a view
    where G is 1 or H, else a copy)."""
    G = t.shape[2]
    if G == H:
        return t
    if G == 1:
        return t.expand(*t.shape[:2], H, t.shape[3])
    return t.repeat_interleave(H // G, dim=2)


def ssd_decode_ref(state, x, log_a, b, c):
    """One token of the SSD recurrence, the reference's ``ssd_decode_step``.

    state: (B, H, N, P) fp32; x: (B, 1, H, P); log_a: (B, 1, H); b, c:
    (B, 1, H, N), or (B, 1, G, N) for G groups of H / G heads each.
    Returns (y: (B, 1, H, P) in x's dtype, the new state (B, H, N, P)
    fp32): ``st = state * exp(log_a) + b xᵀ`` and ``y = c · st``, the
    latter as the batched product over the (row, head) pairs.  The state
    is left as it is."""
    H = x.shape[2]
    b, c = heads_of(b, H), heads_of(c, H)
    a = torch.exp(log_a[:, 0].float())                  # (B, H)
    st = state * a[:, :, None, None] + torch.einsum(
        "bhn,bhp->bhnp", b[:, 0].float(), x[:, 0].float())
    B, _, N, P = st.shape
    y = torch.bmm(c[:, 0].float().flatten(0, 1)[:, None],
                  st.flatten(0, 1))[:, 0]
    return y.unflatten(0, (B, H))[:, None].to(x.dtype), st


def ssd_ref(x, log_a, b, c, *, chunk=128):
    """Mamba-2 SSD as the chunked scan the kernel runs.

    x: (B, S, H, P); log_a: (B, S, H); b, c: (B, S, H, N), or (B, S, G,
    N) for G groups of H / G heads each (broadcast to their heads here).
    Returns (y: (B, S, H, P) in x's dtype, final_state: (B, H, N, P) fp32).

    The sequence is padded to whole chunks with ``log_a = 0`` and
    ``x = b = c = 0``, which leaves the state untouched.  Per chunk: the
    decay-masked ``c·bᵀ`` scores times x, plus ``exp(seg)·c·state``; the
    fp32 state carries across chunks.  ``exp(seg_i - seg_j)`` is taken only
    for ``j <= i``: above the diagonal the exponent is positive and may
    overflow, and ``inf·0`` would be NaN.
    """
    B, S, H, P = x.shape
    N = b.shape[-1]
    if b.shape[2] != H:
        b = b.repeat_interleave(H // b.shape[2], dim=2)
        c = c.repeat_interleave(H // c.shape[2], dim=2)
    L = min(chunk, S)
    S_p = round_up(S, L)
    nc = S_p // L
    xf = pad_axis_to(x.float(), 1, S_p).reshape(B, nc, L, H, P)
    af = pad_axis_to(log_a.float(), 1, S_p).reshape(B, nc, L, H)
    bf = pad_axis_to(b.float(), 1, S_p).reshape(B, nc, L, H, N)
    cf = pad_axis_to(c.float(), 1, S_p).reshape(B, nc, L, H, N)

    seg = torch.cumsum(af, dim=2)                        # (B, nc, L, H)
    total = seg[:, :, -1]                                # (B, nc, H)
    diff = seg[:, :, :, None, :] - seg[:, :, None, :, :]  # (B, nc, Li, Lj, H)
    lower = torch.ones((L, L), dtype=torch.bool, device=x.device).tril()
    decay = diff.masked_fill(~lower[:, :, None], -math.inf).exp()
    scores = torch.einsum("bcihn,bcjhn->bcijh", cf, bf) * decay
    y = torch.einsum("bcijh,bcjhp->bcihp", scores, xf)

    # each chunk's own contribution to the state it hands on
    w = torch.exp(total[:, :, None, :] - seg)            # (B, nc, L, H)
    local = torch.einsum("bclhn,bclh,bclhp->bchnp", bf, w, xf)
    state = torch.zeros((B, H, N, P), dtype=torch.float32, device=x.device)
    inter = []
    for ic in range(nc):
        inter.append(state)
        state = state * torch.exp(total[:, ic])[..., None, None] + local[:, ic]
    state_in = torch.stack(inter, dim=1)                 # (B, nc, H, N, P)
    y = y + torch.exp(seg)[..., None] * torch.einsum(
        "bclhn,bchnp->bclhp", cf, state_in)
    y = y.reshape(B, S_p, H, P)[:, :S]
    return y.to(x.dtype), state
