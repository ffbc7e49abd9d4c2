"""granite-moe-3b-a800m [moe] — 32L d_model=1536 24H (GQA kv=8) expert
d_ff=512, 40 routed experts top-8 (padded to 48 for EP sharding), no shared
expert, vocab=49155 (padded to 49168 for even TP sharding).
[hf:ibm-granite/granite-3.0-1b-a400m-base; assigned dims used verbatim]"""

from repro_torch.models.registry import register
from .base import ModelConfig


@register("granite-moe-3b-a800m")
def config() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-3b-a800m",
        family="moe",
        n_layers=32,
        d_model=1536,
        n_heads=24,
        n_kv_heads=8,
        head_dim=64,
        d_ff=512,                        # per-expert width
        vocab=49168,                     # real 49155, padded %16==0
        pattern=(("attn", "moe"),),
        norm="rmsnorm",
        activation="silu",
        mlp_gated=True,
        rope_theta=10000.0,
        moe_experts=40,
        moe_top_k=8,
        moe_group_size=512,
    )
