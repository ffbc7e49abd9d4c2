"""qwen2-moe-a2.7b [moe] — 24L d_model=2048 16H (kv=16) expert d_ff=1408,
60 routed experts top-4 (padded to 64 for EP sharding) + fused shared expert
(4x1408=5632) with sigmoid gate, vocab=151936.
[hf:Qwen/Qwen1.5-MoE-A2.7B]"""

from repro_torch.models.registry import register
from .base import ModelConfig


@register("qwen2-moe-a2.7b")
def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-moe-a2.7b",
        family="moe",
        n_layers=24,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        head_dim=128,
        d_ff=1408,                       # per-expert width
        vocab=151936,
        pattern=(("attn", "moe"),),
        norm="rmsnorm",
        activation="silu",
        mlp_gated=True,
        rope_theta=1000000.0,
        qkv_bias=True,
        moe_experts=60,
        moe_top_k=4,
        moe_shared_dff=5632,
        moe_group_size=512,
    )
