"""The kernel-bearing Scission graphs.

``kernel_graph`` (prefill: attention -> dense -> SSD -> dense) is the port's
counterpart of the graph ``benchmarks/bench_autotune.py`` builds for the JAX
package: two tunable kernel nodes and two dense layers, so the autotuner,
the BenchmarkDB's ``tuned_params`` and the partitioner all run over real
kernels.  ``decode_graph`` is the same structure over a decode step, with a
decode-attention node over a KV cache in place of each prefill kernel.
``chip_smoke.py`` builds the first at zamba2-2.7b widths (32 heads of
head_dim 80, SSM state 64) and the second at granite-8b widths (32 query
heads, 8 kv heads, head_dim 128, 4096 cached tokens); the tests build both
small.
"""

from __future__ import annotations

import torch

from .core.graph import LayerGraph, LayerNode, TensorSpec, linear_graph
from .kernels.ops import (decode_attention_node, flash_attention_node,
                          ssd_scan_node)


def dense_node(name: str, w: torch.Tensor) -> LayerNode:
    """``tanh(x @ w)`` over the last axis."""
    d_in, d_out = w.shape

    def apply(x):
        # shape tracing runs on meta tensors: the weight follows the input
        return torch.tanh(x @ w.to(x.device))

    return LayerNode(name=name, kind="dense", apply=apply,
                     flops=2.0 * d_in * d_out,
                     param_bytes=w.numel() * w.element_size())


def kernel_graph(input_spec: TensorSpec, weights: dict[str, torch.Tensor], *,
                 state_dim: int, device: str | torch.device = "cuda"
                 ) -> LayerGraph:
    """Causal self-attention -> ``mlp0`` -> SSD(state_dim) -> ``mlp1`` over
    a (B, S, H, hd) activation; ``weights`` holds the (hd, hd) dense
    weights under ``mlp0`` and ``mlp1``."""
    return linear_graph(
        "autotune-demo", input_spec,
        [flash_attention_node("attn", causal=True, device=device),
         dense_node("mlp0", weights["mlp0"]),
         ssd_scan_node("ssd", state_dim=state_dim, device=device),
         dense_node("mlp1", weights["mlp1"])])


def decode_graph(input_spec: TensorSpec, weights: dict[str, torch.Tensor], *,
                 cache_len: int, kv_heads: int, head_dim: int,
                 caches: dict[str, tuple[torch.Tensor, torch.Tensor]]
                 | None = None,
                 device: str | torch.device = "cuda") -> LayerGraph:
    """Decode attention ``attn0`` -> ``mlp0`` -> ``attn1`` -> ``mlp1`` over a
    (batch, H, head_dim) query batch.  Each attention node reads its own
    (batch, cache_len, kv_heads, head_dim) cache: ``caches[name]`` where
    given, else drawn from seed 0 and seed 1; ``weights`` holds the
    (head_dim, head_dim) dense weights under ``mlp0`` and ``mlp1``."""
    caches = caches or {}

    def attn(name, seed):
        return decode_attention_node(
            name, cache_len=cache_len, kv_heads=kv_heads, head_dim=head_dim,
            batch=input_spec.shape[0], seed=seed, cache=caches.get(name),
            device=device)

    return linear_graph(
        "decode-demo", input_spec,
        [attn("attn0", 0), dense_node("mlp0", weights["mlp0"]),
         attn("attn1", 1), dense_node("mlp1", weights["mlp1"])])
