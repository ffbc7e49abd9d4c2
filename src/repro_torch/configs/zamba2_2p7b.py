"""zamba2-2.7b [hybrid] — 54 Mamba2 layers d_model=2560, shared attention
block (32H MHA, head_dim 80) applied every 6 layers, shared-block MLP
d_ff=10240, ssm_state=64, vocab=32000.  [arXiv:2411.15242]

Sub-quadratic: the Mamba2 backbone is O(S); the periodic shared-attention
applications carry the only KV state (sharded over the mesh for long_500k).
"""

from repro_torch.models.registry import register
from .base import ModelConfig


@register("zamba2-2.7b")
def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-2.7b",
        family="hybrid",
        n_layers=54,
        d_model=2560,
        n_heads=32,
        n_kv_heads=32,
        head_dim=80,
        d_ff=10240,
        vocab=32000,
        pattern=(("mamba2",),),
        shared_attn_period=6,            # shared attn+mlp after every 6 mamba
        norm="rmsnorm",
        activation="gelu",
        mlp_gated=True,
        rope_theta=10000.0,
        ssm_state=64,
        ssm_conv=4,
        ssm_expand=2,
        ssm_head_dim=64,
        ssm_chunk=128,
        sub_quadratic=True,
    )
