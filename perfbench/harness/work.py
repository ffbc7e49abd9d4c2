"""The work of a kernel call, counted from its shapes, and the card's
peaks: the yardstick of every roofline and ``mfu`` share.

A call's bound is ``max(FLOPs / peak FLOP/s, bytes / peak bytes/s)``: the
least time the card could take whatever implements the call.  Bytes count
each input read once and each output written once (:func:`moved_bytes`);
FLOPs count what these inputs need (causal pairs exactly, decode rows up
to each row's length, the SSD's linear recurrence), so no implementation
can beat its bound and no share can pass 100%.
"""

from __future__ import annotations

import math

# Frozen copy of chip_smoke.py's PEAKS (commit 69e19e2): dense peaks of the
# card from NVIDIA's data sheets, bf16 tensor FLOP/s and HBM bytes/s.
PEAKS = {"H100 PCIe": (756e12, 2.0e12), "H100 NVL": (835e12, 3.9e12),
         "H100": (989e12, 3.35e12)}


def peaks(name: str) -> tuple[float, float]:
    """(bf16 FLOP/s, bytes/s) of the card called ``name``
    (``torch.cuda.get_device_name``); frozen copy of ``chip_smoke.peaks``."""
    for key, val in PEAKS.items():
        if key in name:
            return val
    raise RuntimeError(f"no peak figures for {name!r}")


def _unique_elements(t) -> int:
    """Elements a view reaches: dimensions of stride 0 (a broadcast) add
    none."""
    return math.prod(n for n, s in zip(t.shape, t.stride()) if s != 0)


def moved_bytes(*tensors) -> float:
    """Bytes a call must move when each input is read once and each output
    written once.  Adapted from ``chip_smoke.moved_bytes`` (commit
    69e19e2): views of one storage with one offset (``q = k = v``) count
    once, at the widest; a broadcast dimension (stride 0, as the SSD's
    head-shared b and c) adds nothing; distinct slices of one storage (b
    and c cut from one projection) each count."""
    spans: dict[tuple, int] = {}
    for t in tensors:
        key = (t.untyped_storage().data_ptr(), t.storage_offset())
        spans[key] = max(spans.get(key, 0),
                         _unique_elements(t) * t.element_size())
    return float(sum(spans.values()))


def flash_flops(B: int, Sq: int, Sk: int, H: int, hd: int,
                causal: bool) -> float:
    """q·kᵀ and p·v over the pairs the mask lets through: ``4·hd`` FLOPs a
    pair and head; causal (aligned at position 0) takes ``sum_i
    min(i + 1, Sk)`` pairs, S(S+1)/2 when Sq = Sk."""
    if causal:
        full = min(Sq, Sk)
        pairs = full * (full + 1) // 2 + max(Sq - Sk, 0) * Sk
    else:
        pairs = Sq * Sk
    return 4.0 * B * H * hd * pairs


def flash_work(q, k, v, o, causal: bool) -> tuple[float, float]:
    B, Sq, H, hd = q.shape
    return (flash_flops(B, Sq, k.shape[1], H, hd, causal),
            moved_bytes(q, k, v, o))


def decode_work(q, k, lengths, o) -> tuple[float, float]:
    """One new token per row against ``lengths[b]`` cache rows (host
    integers): k and v are read only up to each row's length."""
    B, H, hd = q.shape
    Hk = k.shape[2]
    rows = float(sum(int(n) for n in lengths))
    flops = 4.0 * H * hd * rows
    kv = 2.0 * rows * Hk * hd * k.element_size()
    return flops, kv + moved_bytes(q, o) + 4.0 * B


def ssd_work(x, log_a, b, c, y, final) -> tuple[float, float]:
    """The linear recurrence ``s = a·s + b xᵀ``, ``y = c·s``: ``4·N·P``
    FLOPs a position and head (the state update's and the output's
    multiply-adds); b and c read once each, their broadcast over heads
    free."""
    B, S, H, P = x.shape
    N = b.shape[-1]
    return (4.0 * B * S * H * N * P,
            moved_bytes(x, log_a, b, c, y, final))


def bound_s(flops: float, nbytes: float, peak: tuple[float, float]) -> float:
    return max(flops / peak[0], nbytes / peak[1])


def model_flops(n_params: int, tokens: int, train: bool) -> float:
    """6·N·D for training, 2·N·D for inference; frozen copy of the
    arithmetic of ``repro_torch.launch.steps.model_flops`` (commit
    69e19e2)."""
    return (6.0 if train else 2.0) * n_params * tokens
