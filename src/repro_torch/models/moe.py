"""Mixture-of-Experts: top-k token-choice routing with grouped,
capacity-based dispatch, the port of ``repro/models/moe.py``.

Tokens are processed in fixed-size *groups* with a per-group expert
capacity C; each token picks its top-k experts, routing slots are queued
per expert in (token, k) order, and slots past an expert's capacity are
dropped.  Experts are padded to a multiple of 16 (60 -> 64) as the
reference pads them for expert-parallel sharding; padded experts are masked
out of routing at -1e30.

Two dispatches with the same routing semantics, as in the reference:

* :func:`moe_sort` (``impl="sort"``, the default): a stable argsort over
  the routing slots' expert ids, ``searchsorted`` for each slot's queue
  position, an index scatter (dropped slots land in a sentinel column that
  is discarded, as JAX's ``mode="drop"`` discards them) and gathers of the
  token vectors, so every large tensor is O(T·k·D);
* :func:`moe` with ``impl="onehot"``: the GShard einsums against a
  (group, tokens, E, C) one-hot dispatch tensor, kept as the oracle.

The expert products are batched matrix products (``torch.einsum``), which
the reference leaves to XLA; no Pallas kernel lies on this path.  Covers
qwen2-moe-a2.7b (60 routed top-4 + a shared expert behind a sigmoid gate)
and granite-moe-3b (40 routed top-8, no shared expert).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .layers import _ACTIVATIONS, Pm, mlp, mlp_spec


def pad_experts(n_experts: int, multiple: int = 16) -> int:
    return ((n_experts + multiple - 1) // multiple) * multiple


def moe_spec(d_model: int, d_expert: int, n_experts: int,
             n_shared: int = 0, d_shared: int = 0,
             pad_to: int = 16) -> dict:
    E = pad_experts(n_experts, pad_to)
    spec = {
        "router": Pm((d_model, E), ("embed", "experts")),
        "w_gate": Pm((E, d_model, d_expert), ("experts", "embed", "ff")),
        "w_up": Pm((E, d_model, d_expert), ("experts", "embed", "ff")),
        "w_down": Pm((E, d_expert, d_model), ("experts", "ff", "embed")),
    }
    if n_shared:
        spec["shared"] = mlp_spec(d_model, d_shared, gated=True)
        spec["shared_gate"] = Pm((d_model, 1), ("embed", None), init="zeros")
    return spec


def _capacity(g: int, n_experts: int, top_k: int, factor: float) -> int:
    cap = int(math.ceil(g * top_k / n_experts * factor))
    return max(8, ((cap + 7) // 8) * 8)   # 8-aligned, as the reference


def _groups(x, group_size: int):
    """x (B, S, D) as (n, g, D) groups of g = min(group_size, B·S) tokens;
    the token count must be a multiple of g (the reference asserts it)."""
    B, S, D = x.shape
    T = B * S
    g = min(group_size, T)
    if T % g:
        raise ValueError(f"moe: {T} tokens are not a multiple of the group "
                         f"size {g}")
    return x.reshape(T // g, g, D), g


def _route(p, xt, *, top_k: int, n_experts: int):
    """Router probabilities (n, g, E) in fp32, padded experts masked at
    -1e30, and the top-k gates renormalised to sum to 1: (probs, values,
    expert ids)."""
    E = p["router"].shape[1]
    logits = torch.einsum("ngd,de->nge", xt.float(), p["router"].float())
    if n_experts < E:
        pad = torch.arange(E, device=xt.device) >= n_experts
        logits = logits - pad.to(logits.dtype) * 1e30
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.topk(probs, top_k, dim=-1)
    vals = vals / vals.sum(dim=-1, keepdim=True).clamp(min=1e-9)
    return probs, vals, idx


def _aux(probs, idx, n_experts: int):
    """Switch load-balancing loss E · Σ_e f_e p_e over the real experts."""
    E = probs.shape[-1]
    density = F.one_hot(idx, E).float()[..., :n_experts].sum(dim=2) \
        .mean(dim=(0, 1))
    p_mean = probs[..., :n_experts].mean(dim=(0, 1))
    return n_experts * (density * p_mean).sum()


def _experts(p, xe, activation: str):
    """The gated expert MLPs on dispatched tokens xe (n, E, C, D)."""
    act = _ACTIVATIONS[activation]
    h = torch.einsum("necd,edf->necf", xe, p["w_up"])
    gt = torch.einsum("necd,edf->necf", xe, p["w_gate"])
    return torch.einsum("necf,efd->necd", act(gt) * h, p["w_down"])


def _shared(p, xt, yt, activation: str):
    """yt plus the shared expert behind its sigmoid gate, where present."""
    if "shared" not in p:
        return yt
    sg = torch.sigmoid(torch.einsum("ngd,do->ngo", xt.float(),
                                    p["shared_gate"].float()))
    ys = mlp(p["shared"], xt, activation=activation)
    return yt + (sg * ys.float()).to(yt.dtype)


def moe(p, x, *, top_k: int, n_experts: int, capacity_factor: float = 1.25,
        activation: str = "silu", group_size: int = 512,
        impl: str = "sort"):
    """x: (B, S, D) -> (y, aux_loss).

    ``impl="onehot"`` is the GShard-faithful einsum dispatch (the oracle);
    ``impl="sort"`` is :func:`moe_sort`, with the same routing.
    """
    if impl == "sort":
        return moe_sort(p, x, top_k=top_k, n_experts=n_experts,
                        capacity_factor=capacity_factor,
                        activation=activation, group_size=group_size)
    B, S, D = x.shape
    E = p["router"].shape[1]
    xt, g = _groups(x, group_size)
    n = xt.shape[0]
    probs, gate_vals, gate_idx = _route(p, xt, top_k=top_k,
                                        n_experts=n_experts)

    C = _capacity(g, E, top_k, capacity_factor)
    # position of each routing slot in its expert queue; slots are ordered
    # (token-major, then k) within the group
    onehot = F.one_hot(gate_idx, E).float()                 # (n, g, k, E)
    flat = onehot.reshape(n, g * top_k, E)
    pos = (torch.cumsum(flat, dim=1) - flat).reshape(n, g, top_k, E)

    slots = torch.arange(C, device=x.device, dtype=torch.float32)
    combine = torch.zeros((n, g, E, C), dtype=torch.float32,
                          device=x.device)
    for k in range(top_k):
        keep = (pos[:, :, k] < C) & (onehot[:, :, k] > 0)
        # one_hot(pos, C), all zero for a position past the capacity
        slot = (pos[:, :, k, :, None] == slots).float() * keep[..., None]
        combine = combine + slot * gate_vals[:, :, k, None, None]
    dispatch = (combine > 0).to(x.dtype)                    # (n, g, E, C)
    aux = _aux(probs, gate_idx, n_experts)

    xe = torch.einsum("ngec,ngd->necd", dispatch, xt)       # (n, E, C, D)
    ye = _experts(p, xe, activation)
    yt = torch.einsum("ngec,necd->ngd", combine.to(x.dtype), ye)
    yt = _shared(p, xt, yt, activation)
    return yt.reshape(B, S, D), aux


def moe_sort(p, x, *, top_k: int, n_experts: int,
             capacity_factor: float = 1.25, activation: str = "silu",
             group_size: int = 512):
    """Sort-based dispatch: the one-hots replaced by an argsort over the
    routing slots plus index gathers, with the one-hot path's routing
    (token-choice top-k, per-group capacity C, overflow slots dropped in
    slot order)."""
    B, S, D = x.shape
    E = p["router"].shape[1]
    xt, g = _groups(x, group_size)
    n = xt.shape[0]
    dev = x.device
    probs, gate_vals, gate_idx = _route(p, xt, top_k=top_k,
                                        n_experts=n_experts)

    C = _capacity(g, E, top_k, capacity_factor)
    gk = g * top_k
    # routing slots in (token-major, k) order, as the one-hot path
    flat_e = gate_idx.reshape(n, gk)
    order = torch.argsort(flat_e, dim=1, stable=True)       # (n, gk)
    sorted_e = torch.gather(flat_e, 1, order)
    # position of each sorted slot within its expert's segment
    experts = torch.arange(E, device=dev).expand(n, E).contiguous()
    starts = torch.searchsorted(sorted_e, experts)          # (n, E)
    pos_sorted = torch.arange(gk, device=dev)[None, :] - \
        torch.gather(starts, 1, sorted_e)
    keep_sorted = pos_sorted < C
    slot_sorted = sorted_e * C + pos_sorted.clamp(0, C - 1)

    # token of each kept sorted slot; sentinel g for an empty expert slot
    tok_sorted = torch.where(keep_sorted, order // top_k, g)
    # expert slot -> token, by an index scatter; dropped slots write the
    # sentinel column E·C, which is cut off (JAX's mode="drop")
    safe_slot = torch.where(keep_sorted, slot_sorted, E * C)
    tok_for_slot = torch.full((n, E * C + 1), g, dtype=torch.long,
                              device=dev)
    tok_for_slot.scatter_(1, safe_slot, tok_sorted)
    tok_for_slot = tok_for_slot[:, :E * C]

    # dispatch: the token vectors gathered into the expert slots (a zero
    # row for an empty slot)
    xt_pad = torch.cat([xt, xt.new_zeros((n, 1, D))], dim=1)
    xe = torch.gather(xt_pad, 1, tok_for_slot[..., None].expand(n, E * C, D))
    ye = _experts(p, xe.reshape(n, E, C, D), activation)

    # combine: each token gathers its k expert slots back
    pos_unsorted = torch.zeros((n, gk), dtype=torch.long, device=dev) \
        .scatter(1, order, pos_sorted)
    keep_unsorted = torch.gather(keep_sorted, 1, torch.argsort(order, dim=1))
    slot_unsorted = flat_e * C + pos_unsorted.clamp(0, C - 1)
    gathered = torch.gather(ye.reshape(n, E * C, D), 1,
                            slot_unsorted[..., None].expand(n, gk, D))
    w = (gate_vals.reshape(n, gk) * keep_unsorted.float()).to(x.dtype)
    yt = torch.einsum("ngkd,ngk->ngd", gathered.reshape(n, g, top_k, D),
                      w.reshape(n, g, top_k))

    aux = _aux(probs, gate_idx, n_experts)
    yt = _shared(p, xt, yt, activation)
    return yt.reshape(B, S, D), aux
