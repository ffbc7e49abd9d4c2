"""xLSTM blocks (arXiv:2405.04517): mLSTM (matrix memory) and sLSTM
(scalar memory with recurrent gating), the port of ``repro/models/xlstm.py``.

The mLSTM recurrence ``C_t = f_t C_{t-1} + i_t v_t k_tᵀ`` is an SSD
instance (per-head scalar decay ``log σ(f)``, input injection ``i``), so
forward and prefill run the port's :func:`.ssm.ssd`, whose scan is the
hand-written ``ssd_scan`` kernel on the card (4 heads of 384 at
xlstm-125m's widths, the kernel's wide route), and decode the plain
one-token :func:`.ssm.ssd_decode_step`, as the reference.  The sLSTM's gate
recurrence (``R·h_{t-1}``) is a true serial dependency: a Python loop over
time, where the reference runs ``lax.scan``; no Pallas kernel lies there.

The sLSTM's stabiliser ``m`` starts at -1e9 when no state is given
(``forward``) and from the state otherwise: a prefill passes its zeroed
cache, so ``m`` starts at 0 there, and ``forward`` and ``prefill`` give
different logits for the same prompt, in the reference as here.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..core.graph import TensorSpec
from .layers import _ACTIVATIONS, Pm, rmsnorm, rmsnorm_spec
from .ssm import _causal_conv, ssd, ssd_decode_step


# ---------------------------------------------------------------------------
# mLSTM block  (proj factor 2, conv + qkv inside the up-projected space)
# ---------------------------------------------------------------------------

def mlstm_dims(cfg):
    d_inner = 2 * cfg.d_model
    H = cfg.n_heads
    hd = d_inner // H
    return d_inner, H, hd


def mlstm_spec(cfg) -> dict:
    d = cfg.d_model
    d_inner, H, hd = mlstm_dims(cfg)
    return {
        "w_up": Pm((d, 2 * d_inner), ("embed", "ff")),       # [x, z]
        "conv_w": Pm((4, d_inner), ("conv", "ff"), scale=0.5),
        "conv_b": Pm((d_inner,), ("ff",), init="zeros"),
        "wq": Pm((d_inner, d_inner), ("embed", "heads")),
        "wk": Pm((d_inner, d_inner), ("embed", "heads")),
        "wv": Pm((d_inner, d_inner), ("embed", "heads")),
        "w_if": Pm((d_inner, 2 * H), ("embed", "heads")),    # input/forget gates
        "b_if": Pm((2 * H,), ("heads",), init="zeros"),
        "norm": rmsnorm_spec(d_inner),
        "w_down": Pm((d_inner, d), ("ff", "embed")),
    }


def mlstm(p, cfg, x, *, state=None, conv_state=None, decode=False):
    """x: (B, S, D) -> (y, (matrix_state, conv_state))."""
    B, S, D = x.shape
    d_inner, H, hd = mlstm_dims(cfg)

    xi, z = (x @ p["w_up"]).chunk(2, dim=-1)
    xc, new_conv = _causal_conv(p["conv_w"], p["conv_b"], xi,
                                state=conv_state)

    q = (xc @ p["wq"]).reshape(B, S, H, hd)
    k = (xc @ p["wk"]).reshape(B, S, H, hd)
    v = (xi @ p["wv"]).reshape(B, S, H, hd)
    k = k / math.sqrt(hd)

    gates = xc @ p["w_if"] + p["b_if"]
    i_gate, f_gate = gates.float().chunk(2, dim=-1)
    log_f = F.logsigmoid(f_gate)                        # (B,S,H) decay
    i_in = torch.exp(F.logsigmoid(i_gate))              # bounded injection

    xh = v * i_in[..., None].to(v.dtype)
    if decode:
        if state is None:
            state = torch.zeros((B, H, hd, hd), dtype=torch.float32,
                                device=x.device)
        y, new_state = ssd_decode_step(state, xh, log_f, k, q)
    else:
        y, new_state = ssd(xh, log_f, k, q, chunk=cfg.ssm_chunk,
                           initial_state=state)

    y = y.reshape(B, S, d_inner)
    y = rmsnorm(p["norm"], y) * F.silu(z)
    return y @ p["w_down"], (new_state, new_conv)


def mlstm_state_specs(cfg, batch: int) -> tuple[TensorSpec, TensorSpec]:
    """The (matrix, conv) state of one layer: fp32 (B, H, hd, hd) and bf16
    (B, 3, d_inner), as the reference keeps them."""
    d_inner, H, hd = mlstm_dims(cfg)
    return (TensorSpec((batch, H, hd, hd), torch.float32),
            TensorSpec((batch, 3, d_inner), torch.bfloat16))


# ---------------------------------------------------------------------------
# sLSTM block  (scalar memory, recurrent gates, post-FFN with pf = 4/3)
# ---------------------------------------------------------------------------

def slstm_spec(cfg) -> dict:
    d = cfg.d_model
    H = cfg.n_heads
    hd = d // H
    d_ff = int(4 * d / 3)
    return {
        "norm_in": rmsnorm_spec(d),
        "w_in": Pm((d, 4 * d), ("embed", "ff")),             # i, f, z, o
        "r": Pm((H, hd, 4 * hd), ("heads", None, None),
                scale=1.0 / math.sqrt(hd)),                  # block-diag recurrent
        "b": Pm((4 * d,), ("ff",), init="zeros"),
        # post FFN (GLU, pf 4/3): the sLSTM block owns both residuals
        "norm_ff": rmsnorm_spec(d),
        "w_ff_up": Pm((d, 2 * d_ff), ("embed", "ff")),
        "w_ff_down": Pm((d_ff, d), ("ff", "embed")),
    }


def _slstm_cell(r, carry, wx_t):
    """One stabilised sLSTM step; ``r`` the fp32 recurrent weights (H, hd,
    4 hd).  carry: (c, n, h, m) each (B, H, hd)."""
    c, n, h, m = carry
    pre = wx_t + torch.einsum("bhd,hdg->bhg", h, r)     # (B, H, 4*hd)
    i_t, f_t, z_t, o_t = pre.chunk(4, dim=-1)
    log_fm = F.logsigmoid(f_t) + m
    m_new = torch.maximum(log_fm, i_t)                  # stabiliser
    i_s = torch.exp(i_t - m_new)
    f_s = torch.exp(log_fm - m_new)
    c_new = f_s * c + i_s * torch.tanh(z_t)
    n_new = f_s * n + i_s
    h_new = torch.sigmoid(o_t) * c_new / torch.clamp(n_new, min=1.0)
    return (c_new, n_new, h_new, m_new), h_new


def slstm(p, cfg, x, *, state=None, decode=False):
    """x: (B, S, D) raw residual stream -> (y, state).

    Self-residual block (the sLSTM block owns its two residual connections,
    including the pf=4/3 GLU FFN the xLSTM paper attaches to sLSTM).
    state: (c, n, h, m) each (B, H, hd); None starts m at -1e9.
    """
    B, S, D = x.shape
    H = cfg.n_heads
    hd = D // H

    xn = rmsnorm(p["norm_in"], x)
    wx = (xn @ p["w_in"] + p["b"]).float().reshape(B, S, H, 4 * hd)
    if state is None:
        zeros = torch.zeros((B, H, hd), dtype=torch.float32, device=x.device)
        state = (zeros, zeros, zeros,
                 torch.full((B, H, hd), -1e9, dtype=torch.float32,
                            device=x.device))
    r = p["r"].float()

    if decode:
        new_state, h = _slstm_cell(r, tuple(state), wx[:, 0])
        hs = h[:, None]
    else:
        carry, outs = tuple(state), []
        for t in range(S):
            carry, h = _slstm_cell(r, carry, wx[:, t])
            outs.append(h)
        new_state, hs = carry, torch.stack(outs, dim=1)  # (B, S, H, hd)

    x = x + hs.reshape(B, S, D).to(x.dtype)

    # post-FFN (GLU) with its own residual
    a, g = (rmsnorm(p["norm_ff"], x) @ p["w_ff_up"]).chunk(2, dim=-1)
    y = (_ACTIVATIONS["gelu"](g) * a) @ p["w_ff_down"]
    return x + y, new_state


def slstm_state_specs(cfg, batch: int) -> tuple[TensorSpec, ...]:
    """The (c, n, h, m) state of one layer, each fp32 (B, H, hd)."""
    H = cfg.n_heads
    s = TensorSpec((batch, H, cfg.d_model // H), torch.float32)
    return (s, s, s, s)
