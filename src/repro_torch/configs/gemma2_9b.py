"""gemma2-9b [dense] — 42L d_model=3584 16H (GQA kv=8) d_ff=14336
vocab=256000; local+global alternating attention, logit softcapping, GeGLU,
pre+post block norms.  [arXiv:2408.00118]"""

from repro_torch.models.registry import register
from .base import ModelConfig


@register("gemma2-9b")
def config() -> ModelConfig:
    return ModelConfig(
        name="gemma2-9b",
        family="dense",
        n_layers=42,
        d_model=3584,
        n_heads=16,
        n_kv_heads=8,
        head_dim=256,
        d_ff=14336,
        vocab=256000,
        pattern=(("attn_local", "mlp"), ("attn", "mlp")),
        norm="rmsnorm",
        activation="gelu",
        mlp_gated=True,                  # GeGLU
        rope_theta=10000.0,
        window=4096,                     # local layers: sliding window
        attn_softcap=50.0,
        final_softcap=30.0,
        query_pre_attn_scalar=256.0,
        embed_scale=True,
        post_block_norm=True,
        sub_quadratic=False,             # global layers are full attention
    )
