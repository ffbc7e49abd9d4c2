"""The kernel-bearing Scission graph: attention -> dense -> SSD -> dense.

The port's counterpart of the graph ``benchmarks/bench_autotune.py`` builds
for the JAX package: two tunable kernel nodes and two dense layers, so the
autotuner, the BenchmarkDB's ``tuned_params`` and the partitioner all run
over real kernels.  ``chip_smoke.py`` builds it at zamba2-2.7b widths
(32 heads of head_dim 80, SSM state 64); the tests build it small.
"""

from __future__ import annotations

import torch

from .core.graph import LayerGraph, LayerNode, TensorSpec, linear_graph
from .kernels.ops import flash_attention_node, ssd_scan_node


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
