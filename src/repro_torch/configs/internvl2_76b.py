"""internvl2-76b [vlm] — LM backbone 80L d_model=8192 64H (GQA kv=8)
d_ff=28672 vocab=128256; InternViT frontend STUBBED — input_specs supplies
256 precomputed patch embeddings per sample at d_model.  [arXiv:2404.16821]"""

from repro_torch.models.registry import register
from .base import ModelConfig


@register("internvl2-76b")
def config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-76b",
        family="vlm",
        n_layers=80,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        head_dim=128,
        d_ff=28672,
        vocab=128256,
        pattern=(("attn", "mlp"),),
        norm="rmsnorm",
        activation="silu",
        mlp_gated=True,
        rope_theta=500000.0,
        n_img_tokens=256,
    )
