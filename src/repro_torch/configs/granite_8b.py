"""granite-8b [dense] — 36L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=49152; llama-style SwiGLU + RMSNorm + RoPE (code model).
[arXiv:2405.04324]"""

from repro_torch.models.registry import register
from .base import ModelConfig


@register("granite-8b")
def config() -> ModelConfig:
    return ModelConfig(
        name="granite-8b",
        family="dense",
        n_layers=36,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab=49152,
        pattern=(("attn", "mlp"),),
        norm="rmsnorm",
        activation="silu",
        mlp_gated=True,                  # SwiGLU
        rope_theta=10000.0,
    )
