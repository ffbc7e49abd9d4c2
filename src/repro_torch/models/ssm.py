"""Mamba-2 (SSD) blocks: the port of ``repro/models/ssm.py``.

:func:`ssd` runs the chunked state-space-duality scan through the port's
``kernels.ssd_scan`` (the hand-written kernel on the card, its plain version
on the CPU) and adds what the kernel lacks in exact linear terms outside it:
head-shared b, c (Mamba-2's ngroups = 1) are broadcast to the heads as
stride-0 views, which the kernel reads as they are; b, c of G groups
(ngroups = G, H / G heads a group) go to the kernel as they are, read by
group; and an initial state s0 adds ``exp(cumsum(log_a)) (c . s0)`` to y
and ``exp(sum(log_a)) s0`` to the final state.  Any sequence length
prefills: the kernel pads the last chunk with steps that leave the state
as it is, and drops their outputs.  A decode's one-token step is the
port's ``kernels.ssd_decode`` (the reference's ``ssd_decode_step``, a
kernel on the card that reads b, c by group and writes the new state into
the cache's slice in place; its plain version on the CPU).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..core.graph import TensorSpec
from ..kernels.ref import heads_of
from ..kernels.ssd_scan import ssd_decode, ssd_scan
from ..kernels.substrate import DEFAULT_PARAMS, serving_param
from ..runtime.sharding import constrain, flatten, unflatten
from .layers import Pm, matmul, rmsnorm, rmsnorm_spec


# ---------------------------------------------------------------------------
# SSD core: y = SSD(x, a, b, c) with per-(position, head) scalar decay
# ---------------------------------------------------------------------------

def ssd(x, log_a, b, c, *, chunk: int | None = None, initial_state=None):
    """Chunked state-space duality scan.

    x:      (B, S, H, P)    inputs (already gated / dt-scaled)
    log_a:  (B, S, H)       per-step log decay (<= 0)
    b:      (B, S, Hb, N)   input maps  ("K"); Hb == H, Hb == 1 for
    c:      (B, S, Hb, N)   head-shared maps (Mamba-2 ngroups=1), or Hb
                            groups of H / Hb heads each
    initial_state: (B, H, N, P) fp32 or None
    returns (y: (B, S, H, P), final_state: (B, H, N, P) fp32)

    ``chunk=None`` resolves to the adopted tuned ``ssd_scan`` ``chunk``
    (``kernels/substrate.adopt_tuned_params``), else the kernel's default;
    model configs that pin ``ssm_chunk`` pass it explicitly.  ``S`` need
    not be a multiple of ``min(chunk, S)``: the last chunk is padded with
    identity steps (x = 0, log_a = 0, b = c = 0), whose outputs are dropped.
    """
    if chunk is None:
        chunk = serving_param("ssd_scan", "chunk",
                              DEFAULT_PARAMS["ssd_scan"]["chunk"])
    B, S, H, P = x.shape
    Hb, N = b.shape[-2], b.shape[-1]
    if H % Hb:
        raise ValueError(f"ssd: {Hb} groups of b, c do not divide {H} heads")
    shared = Hb == 1
    bh = b.expand(B, S, H, N) if shared else b
    ch = c.expand(B, S, H, N) if shared else c
    y, final = ssd_scan(x, log_a, bh, ch, chunk=min(chunk, S))
    if initial_state is None:
        return y, final

    s0 = initial_state.float()
    seg = torch.cumsum(log_a.float(), dim=1)            # (B, S, H)
    if shared:
        cs0 = torch.einsum("bsn,bhnp->bshp", c[:, :, 0].float(), s0)
    else:
        cs0 = torch.einsum("bshn,bhnp->bshp",
                           heads_of(c, H).float(), s0)
    y = (y.float() + torch.exp(seg)[..., None] * cs0).to(x.dtype)
    final = final + torch.exp(seg[:, -1])[..., None, None] * s0
    return y, final


# ---------------------------------------------------------------------------
# Mamba-2 block
# ---------------------------------------------------------------------------

def mamba2_dims(cfg):
    d_inner = cfg.ssm_expand * cfg.d_model
    nheads = d_inner // cfg.ssm_head_dim
    conv_dim = d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
    return d_inner, nheads, conv_dim


def mamba2_spec(cfg) -> dict:
    d = cfg.d_model
    d_inner, H, conv_dim = mamba2_dims(cfg)
    return {
        # fused input projection: [z, x, B, C, dt], B and C G N wide
        "w_in": Pm((d, d_inner + conv_dim + H), ("embed", "ff")),
        "conv_w": Pm((cfg.ssm_conv, conv_dim), ("conv", "ff"), scale=0.5),
        "conv_b": Pm((conv_dim,), ("ff",), init="zeros"),
        "a_log": Pm((H,), ("heads",), init="zeros"),
        "d_skip": Pm((H,), ("heads",), init="ones"),
        "dt_bias": Pm((H,), ("heads",), init="zeros"),
        "norm": rmsnorm_spec(d_inner),
        "w_out": Pm((d_inner, d), ("ff", "embed")),
    }


def _split_in(cfg, h):
    d_inner, H, conv_dim = mamba2_dims(cfg)
    return torch.split(h, [d_inner, conv_dim, H], dim=-1)


_DT_OFFSETS: dict = {}


def dt_offset(cfg, H: int, device) -> torch.Tensor | None:
    """Mamba-2's initial dt_bias, ``softplus^-1(dt)`` with dt log-spaced
    over the H heads across ``cfg.ssm_dt_range`` (the published
    initialisation draws each head's dt log-uniformly there), or None.
    With it, ``dt_bias`` is held as the offset from that value, as each
    RMSNorm weight is held as the offset from 1: a draw of zeros is the
    published initial state.  Built once per range, H and device (not
    while a CUDA graph is captured, whose pool would own it) and kept."""
    if cfg.ssm_dt_range is None:
        return None
    key = (tuple(cfg.ssm_dt_range), H, torch.device(device))
    out = _DT_OFFSETS.get(key)
    if out is None:
        lo, hi = (math.log(v) for v in cfg.ssm_dt_range)
        dt = torch.exp(torch.linspace(lo, hi, H, device=device))
        out = dt + torch.log(-torch.expm1(-dt))
        if not (out.is_cuda and torch.cuda.is_current_stream_capturing()):
            _DT_OFFSETS[key] = out
    return out


def _gated_norm(p, y, z, groups: int, eps: float):
    """RMSNorm of ``y * silu(z)`` over each of ``groups`` equal groups of
    channels, in fp32, scaled by ``1 + scale``: Mamba-2's gated norm with
    the gate applied first."""
    dt = y.dtype
    h = y.float() * F.silu(z.float())
    h = unflatten(h, -1, (groups, h.shape[-1] // groups))
    h = h * torch.rsqrt(h.square().mean(dim=-1, keepdim=True) + eps)
    return (flatten(h, -2, -1) * (1.0 + p["scale"].float())).to(dt)


def _causal_conv(w, bias, x, state=None):
    """Depthwise causal conv1d.  x: (B, S, C); state: (B, K-1, C) or None.
    Returns (y, new_state)."""
    K = w.shape[0]
    if state is None:
        pad = torch.zeros((x.shape[0], K - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    y = sum(xp[:, i:i + x.shape[1]] * w[i] for i in range(K))
    new_state = xp[:, -(K - 1):] if K > 1 else None
    return F.silu(y + bias), new_state


def mamba2(p, cfg, x, *, state=None, conv_state=None, decode=False,
           state_out=None):
    """x: (B, S, D) -> (y, (ssm_state, conv_state)).

    ``decode=True`` runs the O(1) recurrent update (S == 1 expected),
    writing the new state into ``state_out`` when given (which may be
    ``state``, updated in place) and returning it; otherwise the chunked
    SSD scan (training / prefill).
    """
    B, S, D = x.shape
    d_inner, H, conv_dim = mamba2_dims(cfg)
    N, G = cfg.ssm_state, cfg.ssm_groups
    P = cfg.ssm_head_dim

    h = constrain(matmul(x, p["w_in"]), "act_batch", None, "act_ff")
    z, xbc, dt = _split_in(cfg, h)
    xbc, new_conv = _causal_conv(p["conv_w"], p["conv_b"], xbc,
                                 state=conv_state)
    xs, b_in, c_out = torch.split(xbc, [d_inner, G * N, G * N], dim=-1)
    b_in, c_out = unflatten(b_in, 2, (G, N)), unflatten(c_out, 2, (G, N))

    dt_bias = p["dt_bias"].float()
    offset = dt_offset(cfg, H, x.device)
    if offset is not None:
        dt_bias = dt_bias + offset
    dt = F.softplus(dt.float() + dt_bias)               # (B,S,H)
    a = -torch.exp(p["a_log"].float())                  # (H,) negative
    log_a = dt * a                                      # (B,S,H)

    xh = unflatten(xs, 2, (H, P)) * dt[..., None].to(xs.dtype)

    if decode:
        if state is None:
            state = torch.zeros((B, H, N, P), dtype=torch.float32,
                                device=x.device)
        # b and c read by group, as the scan reads them
        y, new_state = ssd_decode(state, xh, log_a, b_in, c_out,
                                  out=state_out)
    else:
        # B/C of each group are shared by its heads: ssd broadcasts one
        # group as stride-0 views, and the kernel reads several by group
        y, new_state = ssd(xh, log_a, b_in, c_out, chunk=cfg.ssm_chunk,
                           initial_state=state)

    y = y + unflatten(xs, 2, (H, P)) * p["d_skip"].to(xs.dtype)[:, None]
    y = flatten(y, 2, 3)
    if cfg.ssm_gate_before_norm:
        y = _gated_norm(p["norm"], y, z, G, cfg.norm_eps)
    else:
        y = rmsnorm(p["norm"], y, cfg.norm_eps) * F.silu(z)
    out = constrain(matmul(y, p["w_out"]), "act_batch", "act_seq", None)
    return out, (new_state, new_conv)


def mamba2_state_specs(cfg, batch: int) -> tuple[TensorSpec, TensorSpec]:
    """The (ssm, conv) state of one layer: fp32 (B, H, N, P) and bf16
    (B, K-1, conv_dim), as the reference keeps them."""
    d_inner, H, conv_dim = mamba2_dims(cfg)
    ssm = TensorSpec((batch, H, cfg.ssm_state, cfg.ssm_head_dim),
                     torch.float32)
    conv = TensorSpec((batch, cfg.ssm_conv - 1, conv_dim), torch.bfloat16)
    return ssm, conv


def mamba2_state_axes() -> tuple[tuple, tuple]:
    """The logical axes of :func:`mamba2_state_specs`."""
    return ("act_batch", "act_heads", None, None), ("act_batch", None,
                                                    "act_ff")
