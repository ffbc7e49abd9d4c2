"""Public kernel entry points and tunable graph nodes.

The ``*_node`` builders wrap each kernel as a ``LayerNode`` carrying the
autotuner metadata (``kernel``, ``kernel_factory``, ``kernel_params``):
benchmark providers constructed with a
:class:`~repro_torch.kernels.substrate.KernelAutotuner` sweep block sizes
for these nodes before timing them, so partition decisions are made from
tuned, not default, kernel timings.  A node runs its kernel on whatever
device its input lies on: the CUDA kernel on the card, the plain version on
the CPU and on ``meta`` while the graph is traced.
"""

from __future__ import annotations

import torch.nn.functional as F

from .._device import resolve_device
from .flash_attention import flash_attention, smem_bytes as _fa_smem
from .ssd_scan import smem_bytes as _ssd_smem, ssd_scan
from .substrate import DEFAULT_PARAMS

__all__ = ["flash_attention", "ssd_scan", "flash_attention_node",
           "ssd_scan_node", "smem_footprint"]


def smem_footprint(kernel: str, params: dict, args, options=None) -> int:
    """Shared memory per CTA of ``kernel``'s launch inside a node whose input
    is ``args[0]``, at block sizes ``params`` (the autotuner's prune)."""
    x = tuple(args[0].shape)
    if kernel == "flash_attention":            # q = k = v = x
        return _fa_smem(params, (x, x))
    if kernel == "ssd_scan":                   # b = c = x[..., :state_dim]
        n = (options or {}).get("state_dim", 16)
        return _ssd_smem(params, (x, (*x[:-1], n)))
    raise KeyError(f"no shared-memory model for kernel {kernel!r}")


def _layer_node(name, kind, kernel, factory, params, options, device,
                flops=0.0):
    from ..core.graph import LayerNode  # lazy: core imports substrate
    resolve_device(device)
    params = dict(DEFAULT_PARAMS[kernel], **(params or {}))
    return LayerNode(name=name, kind=kind, apply=factory(params),
                     flops=flops, kernel=kernel, kernel_factory=factory,
                     kernel_params=params, kernel_defaults=dict(params),
                     kernel_options={k: v for k, v in options.items()
                                     if v is not None})


def flash_attention_node(name="flash_attention", *, causal=True, window=None,
                         softcap=None, params=None, device="cuda"):
    """Self-attention layer over an (B, S, H, hd) activation (q = k = v)."""

    def factory(p):
        def apply(x):
            return flash_attention(x, x, x, causal=causal, window=window,
                                   softcap=softcap, block_q=p["block_q"],
                                   block_k=p["block_k"])
        return apply

    return _layer_node(name, "attention", "flash_attention", factory, params,
                       {"causal": causal, "window": window,
                        "softcap": softcap}, device)


def ssd_scan_node(name="ssd_scan", *, state_dim=16, params=None,
                  device="cuda"):
    """SSD mixer over an (B, S, H, P) activation; B/C projections are cheap
    slices of the input so the node stays single-input."""

    def factory(p):
        def apply(x):
            log_a = -F.softplus(x.mean(dim=-1))
            bc = x[..., :state_dim]
            y, _ = ssd_scan(x, log_a, bc, bc, chunk=p["chunk"])
            return y
        return apply

    return _layer_node(name, "ssm", "ssd_scan", factory, params,
                       {"state_dim": state_dim}, device)

