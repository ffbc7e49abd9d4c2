"""starcoder2-15b [dense] — 40L d_model=6144 48H (GQA kv=4) d_ff=24576
vocab=49152; GQA + RoPE, LayerNorm, plain GELU MLP, qkv bias.
[arXiv:2402.19173]"""

from repro_torch.models.registry import register
from .base import ModelConfig


@register("starcoder2-15b")
def config() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-15b",
        family="dense",
        n_layers=40,
        d_model=6144,
        n_heads=48,
        n_kv_heads=4,
        head_dim=128,
        d_ff=24576,
        vocab=49152,
        pattern=(("attn", "mlp"),),
        norm="layernorm",
        activation="gelu",
        mlp_gated=False,
        rope_theta=100000.0,
        qkv_bias=True,
    )
