"""xLSTM blocks (arXiv:2405.04517): mLSTM (matrix memory) and sLSTM
(scalar memory with recurrent gating), the port of ``repro/models/xlstm.py``.

The mLSTM recurrence ``C_t = f_t C_{t-1} + i_t v_t k_tᵀ`` is an SSD
instance (per-head scalar decay ``log σ(f)``, input injection ``i``), so
forward and prefill run the port's :func:`.ssm.ssd`, whose scan is the
hand-written ``ssd_scan`` kernel on the card (4 heads of 384 at
xlstm-125m's widths, the kernel's wide route), and decode the port's
one-token ``kernels.ssd_decode`` (the reference's ``ssd_decode_step``: a
kernel on the card that writes the state into the cache in place).  The
sLSTM's gate recurrence (``R·h_{t-1}``) is a true serial dependency: a
Python loop over time, where the reference runs ``lax.scan``; no Pallas
kernel lies there.

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
from ..kernels.ssd_scan import ssd_decode
from ..runtime.sharding import constrain, flatten, per_shard, unflatten
from .layers import _ACTIVATIONS, Pm, matmul, rmsnorm, rmsnorm_spec
from .ssm import _causal_conv, ssd


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


def mlstm(p, cfg, x, *, state=None, conv_state=None, decode=False,
          state_out=None):
    """x: (B, S, D) -> (y, (matrix_state, conv_state)); a decode writes the
    new matrix state into ``state_out`` when given (see :func:`.ssm.mamba2`)."""
    B, S, D = x.shape
    d_inner, H, hd = mlstm_dims(cfg)

    up = constrain(matmul(x, p["w_up"]), "act_batch", None, "act_ff")
    xi, z = up.chunk(2, dim=-1)
    xc, new_conv = _causal_conv(p["conv_w"], p["conv_b"], xi,
                                state=conv_state)

    q = unflatten(matmul(xc, p["wq"]), 2, (H, hd))
    k = unflatten(matmul(xc, p["wk"]), 2, (H, hd))
    v = unflatten(matmul(xi, p["wv"]), 2, (H, hd))
    k = k / math.sqrt(hd)

    gates = matmul(xc, p["w_if"]) + p["b_if"]
    i_gate, f_gate = gates.float().chunk(2, dim=-1)
    # log-sigmoid per shard: DTensor has no rule for its backward
    log_f = per_shard(F.logsigmoid, f_gate)             # (B,S,H) decay
    i_in = torch.exp(per_shard(F.logsigmoid, i_gate))   # bounded injection

    xh = v * i_in[..., None].to(v.dtype)
    if decode:
        if state is None:
            state = torch.zeros((B, H, hd, hd), dtype=torch.float32,
                                device=x.device)
        y, new_state = ssd_decode(state, xh, log_f, k, q, out=state_out)
    else:
        y, new_state = ssd(xh, log_f, k, q, chunk=cfg.ssm_chunk,
                           initial_state=state)

    y = flatten(y, 2, 3)
    y = rmsnorm(p["norm"], y) * F.silu(z)
    out = constrain(matmul(y, p["w_down"]), "act_batch", "act_seq", None)
    return out, (new_state, new_conv)


def mlstm_state_specs(cfg, batch: int) -> tuple[TensorSpec, TensorSpec]:
    """The (matrix, conv) state of one layer: fp32 (B, H, hd, hd) and bf16
    (B, 3, d_inner), as the reference keeps them."""
    d_inner, H, hd = mlstm_dims(cfg)
    return (TensorSpec((batch, H, hd, hd), torch.float32),
            TensorSpec((batch, 3, d_inner), torch.bfloat16))


def mlstm_state_axes() -> tuple[tuple, tuple]:
    """The logical axes of :func:`mlstm_state_specs`."""
    return ("act_batch", "act_heads", None, None), ("act_batch", None,
                                                    "act_ff")


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
    log_fm = per_shard(F.logsigmoid, f_t) + m
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
    wx = unflatten((matmul(xn, p["w_in"]) + p["b"]).float(), 2, (H, 4 * hd))
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

    x = x + constrain(flatten(hs, 2, 3).to(x.dtype),
                      "act_batch", "act_seq", None)

    # post-FFN (GLU) with its own residual
    a, g = matmul(rmsnorm(p["norm_ff"], x), p["w_ff_up"]).chunk(2, dim=-1)
    y = matmul(_ACTIVATIONS["gelu"](g) * a, p["w_ff_down"])
    return x + constrain(y, "act_batch", "act_seq", None), new_state


def slstm_state_specs(cfg, batch: int) -> tuple[TensorSpec, ...]:
    """The (c, n, h, m) state of one layer, each fp32 (B, H, hd)."""
    H = cfg.n_heads
    s = TensorSpec((batch, H, cfg.d_model // H), torch.float32)
    return (s, s, s, s)


def slstm_state_axes() -> tuple[tuple, ...]:
    """The logical axes of each of :func:`slstm_state_specs`' four."""
    return (("act_batch", "act_heads", None),) * 4
