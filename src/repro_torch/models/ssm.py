"""Mamba-2 (SSD) blocks: the port of ``repro/models/ssm.py``.

:func:`ssd` runs the chunked state-space-duality scan through the port's
``kernels.ssd_scan`` (the hand-written kernel on the card, its plain version
on the CPU) and adds what the kernel lacks in exact linear terms outside it:
head-shared b, c (Mamba-2's ngroups = 1) are broadcast to the heads as
stride-0 views, which the kernel reads as they are, and an initial state s0
adds ``exp(cumsum(log_a)) (c . s0)`` to y and ``exp(sum(log_a)) s0`` to the
final state.  :func:`ssd_decode_step` is the reference's one-token
recurrence, plain PyTorch as there.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.graph import TensorSpec
from ..kernels.ssd_scan import ssd_scan
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
    b:      (B, S, Hb, N)   input maps  ("K"); Hb == H, or Hb == 1 for
    c:      (B, S, Hb, N)   head-shared maps (Mamba-2 ngroups=1)
    initial_state: (B, H, N, P) fp32 or None
    returns (y: (B, S, H, P), final_state: (B, H, N, P) fp32)

    ``chunk=None`` resolves to the adopted tuned ``ssd_scan`` ``chunk``
    (``kernels/substrate.adopt_tuned_params``), else the kernel's default;
    model configs that pin ``ssm_chunk`` pass it explicitly.  As in the
    reference, ``S`` must be a multiple of ``min(chunk, S)``.
    """
    if chunk is None:
        chunk = serving_param("ssd_scan", "chunk",
                              DEFAULT_PARAMS["ssd_scan"]["chunk"])
    B, S, H, P = x.shape
    Hb, N = b.shape[-2], b.shape[-1]
    L = min(chunk, S)
    if S % L:
        raise ValueError(f"ssd: the sequence {S} is not a multiple of the "
                         f"chunk {L}")
    shared = Hb == 1
    bh = b.expand(B, S, H, N) if shared else b
    ch = c.expand(B, S, H, N) if shared else c
    y, final = ssd_scan(x, log_a, bh, ch, chunk=L)
    if initial_state is None:
        return y, final

    s0 = initial_state.float()
    seg = torch.cumsum(log_a.float(), dim=1)            # (B, S, H)
    if shared:
        cs0 = torch.einsum("bsn,bhnp->bshp", c[:, :, 0].float(), s0)
    else:
        cs0 = torch.einsum("bshn,bhnp->bshp", c.float(), s0)
    y = (y.float() + torch.exp(seg)[..., None] * cs0).to(x.dtype)
    final = final + torch.exp(seg[:, -1])[..., None, None] * s0
    return y, final


def ssd_decode_step(state, x, log_a, b, c):
    """One-token recurrent update.  x: (B,1,H,P) etc.  Returns (y, state)."""
    a = torch.exp(log_a[:, 0].float())                  # (B, H)
    st = state * a[:, :, None, None] + torch.einsum(
        "bhn,bhp->bhnp", b[:, 0].float(), x[:, 0].float())
    # einsum("bhn,bhnp->bhp") as the batched product it runs, over rows
    # that flatten/unflatten lay out (a DTensor's heads split kept apart)
    B, H, N, P = st.shape
    y = torch.bmm(flatten(c[:, 0].float(), 0, 1)[:, None],
                  flatten(st, 0, 1))[:, 0]
    y = unflatten(y, 0, (B, H))
    return y[:, None].to(x.dtype), st


# ---------------------------------------------------------------------------
# Mamba-2 block
# ---------------------------------------------------------------------------

def mamba2_dims(cfg):
    d_inner = cfg.ssm_expand * cfg.d_model
    nheads = d_inner // cfg.ssm_head_dim
    conv_dim = d_inner + 2 * cfg.ssm_state
    return d_inner, nheads, conv_dim


def mamba2_spec(cfg) -> dict:
    d = cfg.d_model
    d_inner, H, conv_dim = mamba2_dims(cfg)
    N = cfg.ssm_state
    return {
        # fused input projection: [z, x, B, C, dt]
        "w_in": Pm((d, 2 * d_inner + 2 * N + H), ("embed", "ff")),
        "conv_w": Pm((cfg.ssm_conv, conv_dim), ("conv", "ff"), scale=0.5),
        "conv_b": Pm((conv_dim,), ("ff",), init="zeros"),
        "a_log": Pm((H,), ("heads",), init="zeros"),
        "d_skip": Pm((H,), ("heads",), init="ones"),
        "dt_bias": Pm((H,), ("heads",), init="zeros"),
        "norm": rmsnorm_spec(d_inner),
        "w_out": Pm((d_inner, d), ("ff", "embed")),
    }


def _split_in(cfg, h):
    d_inner, H, _ = mamba2_dims(cfg)
    N = cfg.ssm_state
    return torch.split(h, [d_inner, d_inner + 2 * N, H], dim=-1)


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


def mamba2(p, cfg, x, *, state=None, conv_state=None, decode=False):
    """x: (B, S, D) -> (y, (ssm_state, conv_state)).

    ``decode=True`` runs the O(1) recurrent update (S == 1 expected);
    otherwise the chunked SSD scan (training / prefill).
    """
    B, S, D = x.shape
    d_inner, H, conv_dim = mamba2_dims(cfg)
    N = cfg.ssm_state
    P = cfg.ssm_head_dim

    h = constrain(matmul(x, p["w_in"]), "act_batch", None, "act_ff")
    z, xbc, dt = _split_in(cfg, h)
    xbc, new_conv = _causal_conv(p["conv_w"], p["conv_b"], xbc,
                                 state=conv_state)
    xs, b_in, c_out = torch.split(xbc, [d_inner, N, N], dim=-1)

    dt = F.softplus(dt.float() + p["dt_bias"].float())  # (B,S,H)
    a = -torch.exp(p["a_log"].float())                  # (H,) negative
    log_a = dt * a                                      # (B,S,H)

    xh = unflatten(xs, 2, (H, P)) * dt[..., None].to(xs.dtype)

    if decode:
        if state is None:
            state = torch.zeros((B, H, N, P), dtype=torch.float32,
                                device=x.device)
        bh = b_in[:, :, None, :].expand(B, S, H, N)
        ch = c_out[:, :, None, :].expand(B, S, H, N)
        y, new_state = ssd_decode_step(state, xh, log_a, bh, ch)
    else:
        # B/C are shared across heads (ngroups=1): ssd broadcasts them as
        # stride-0 views
        y, new_state = ssd(xh, log_a, b_in[:, :, None, :],
                           c_out[:, :, None, :], chunk=cfg.ssm_chunk,
                           initial_state=state)

    y = y + unflatten(xs, 2, (H, P)) * p["d_skip"].to(xs.dtype)[:, None]
    y = flatten(y, 2, 3)
    y = rmsnorm(p["norm"], y) * F.silu(z)
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
