"""zamba2-7b [hybrid] — Zamba2-7B-Instruct as published: 81 Mamba-2 layers
at d_model 3584 (112 heads of 64, 2 groups of B and C, state 64, chunk
256); before each of the 13 layers in ``hybrid_layer_ids`` one of 2 shared
blocks, in turn, over concat(x, embedding) (7168 wide): 32 MHA heads of 224
with rope over the whole head, scale (224 / 2)^-1/2, then a gated GELU MLP
(d_ff 14336) with a rank-128 LoRA per application on its gate and up
projections, and a per-application 3584 x 3584 linear whose output joins
the next Mamba layer's input.  vocab 32000, RMSNorm eps 1e-5.  dt_bias is
held as the offset from Mamba-2's initial value (dt over [1e-3, 0.1]).
[arXiv:2411.15242; huggingface.co/Zyphra/Zamba2-7B-Instruct config.json]
"""

from repro_torch.models.registry import register
from .base import ModelConfig


@register("zamba2-7b")
def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-7b",
        family="hybrid",
        n_layers=81,
        d_model=3584,
        n_heads=32,
        n_kv_heads=32,
        head_dim=224,                    # attention_head_dim: 2 d / heads
        d_ff=14336,
        vocab=32000,
        pattern=(("mamba2",),),
        norm="rmsnorm",
        norm_eps=1e-5,
        activation="gelu_erf",
        mlp_gated=True,
        rope_theta=10000.0,
        query_pre_attn_scalar=112.0,     # scale (head_dim / 2)^-1/2
        ssm_state=64,
        ssm_conv=4,
        ssm_expand=2,
        ssm_head_dim=64,
        ssm_chunk=256,
        ssm_groups=2,
        ssm_gate_before_norm=True,
        ssm_dt_range=(1e-3, 0.1),        # time_step_min, time_step_max
        hybrid_layer_ids=(6, 11, 17, 23, 29, 35, 41, 47, 53, 59, 65, 71, 77),
        n_shared_blocks=2,
        shared_adapter_rank=128,
        sub_quadratic=True,
    )
