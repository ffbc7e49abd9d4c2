"""gemma-7b [dense] — 28L d_model=3072 16H (kv=16, MHA) d_ff=24576
vocab=256000; GeGLU, head_dim=256 (attention width 4096 > d_model).
[arXiv:2403.08295]"""

from repro_torch.models.registry import register
from .base import ModelConfig


@register("gemma-7b")
def config() -> ModelConfig:
    return ModelConfig(
        name="gemma-7b",
        family="dense",
        n_layers=28,
        d_model=3072,
        n_heads=16,
        n_kv_heads=16,
        head_dim=256,
        d_ff=24576,
        vocab=256000,
        pattern=(("attn", "mlp"),),
        norm="rmsnorm",
        activation="gelu",
        mlp_gated=True,                  # GeGLU
        rope_theta=10000.0,
        query_pre_attn_scalar=256.0,
        embed_scale=True,
    )
