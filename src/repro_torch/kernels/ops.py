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

import torch
import torch.nn.functional as F

from .._device import resolve_device
from .decode_attention import decode_attention
from .flash_attention import flash_attention
from .ssd_scan import ssd_scan
from .substrate import DEFAULT_PARAMS

__all__ = ["flash_attention", "decode_attention", "ssd_scan",
           "flash_attention_node", "decode_attention_node", "ssd_scan_node"]


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


def decode_attention_node(name="decode_attention", *, cache_len, kv_heads,
                          head_dim, batch=1, softcap=None, params=None, seed=0,
                          cache=None, device="cuda"):
    """Decode step over a fixed (batch, cache_len, kv_heads, head_dim) KV
    cache, every row ``cache_len`` long; the node input is the (batch, H,
    hd) query batch.

    The cache is ``cache=(k, v)``, or standard normals drawn once in fp32
    on ``device`` from a ``torch.Generator`` seeded with ``seed`` (k, then
    v).  It is converted to the input's dtype and device once per (dtype,
    device) and kept, so timed runs move only what the kernel moves; under
    shape tracing on ``meta`` it follows the input, as ``dense_node``'s
    weight does.  ``cache`` and ``device`` are not kernel options: the
    tuner's config key stays the JAX node's.
    """
    dev = resolve_device(device)
    shape = (batch, cache_len, kv_heads, head_dim)
    if cache is None:
        gen = torch.Generator(device=dev).manual_seed(seed)
        cache = tuple(torch.randn(shape, generator=gen, device=dev)
                      for _ in range(2))
    elif len(cache) != 2 or any(tuple(c.shape) != shape for c in cache):
        raise ValueError(f"cache must be two {shape} tensors, got "
                         f"{[tuple(c.shape) for c in cache]}")
    held = {}

    def cache_for(x):
        key = (x.dtype, x.device)
        if key not in held:
            held[key] = (*(c.to(x.device, x.dtype) for c in cache),
                         torch.full((batch,), cache_len, dtype=torch.int32,
                                    device=x.device))
        return held[key]

    def factory(p):
        def apply(q):
            k, v, lengths = cache_for(q)
            return decode_attention(q, k, v, lengths, softcap=softcap,
                                    block_k=p["block_k"])
        return apply

    return _layer_node(name, "attention", "decode_attention", factory, params,
                       {"cache_len": cache_len, "kv_heads": kv_heads,
                        "head_dim": head_dim, "softcap": softcap,
                        "seed": seed}, device)


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

