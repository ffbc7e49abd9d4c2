"""xlstm-125m [ssm] — 12L d_model=768 4H vocab=50304; alternating
mLSTM (matrix memory, SSD-form chunkwise) and sLSTM (scalar memory,
recurrent-gate scan) blocks; d_ff=0 — projections live inside the blocks.
[arXiv:2405.04517]"""

from repro_torch.models.registry import register
from .base import ModelConfig


@register("xlstm-125m")
def config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-125m",
        family="ssm",
        n_layers=12,
        d_model=768,
        n_heads=4,
        n_kv_heads=4,
        head_dim=192,
        d_ff=0,
        vocab=50304,
        pattern=(("mlstm",), ("slstm",)),
        norm="rmsnorm",
        activation="gelu",
        use_rope=False,
        ssm_chunk=128,
        sub_quadratic=True,
    )
