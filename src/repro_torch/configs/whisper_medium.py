"""whisper-medium [audio] — enc-dec, 24+24L d_model=1024 16H (MHA)
d_ff=4096 vocab=51865 (padded to 51872 for even TP sharding); conv/mel
frontend STUBBED — input_specs supplies frame embeddings (B, 1500, d).
[arXiv:2212.04356]"""

from repro_torch.models.registry import register
from .base import ModelConfig


@register("whisper-medium")
def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-medium",
        family="audio",
        n_layers=24,                     # decoder layers
        d_model=1024,
        n_heads=16,
        n_kv_heads=16,
        head_dim=64,
        d_ff=4096,
        vocab=51872,                     # real 51865, padded %16==0
        pattern=(("attn", "mlp"),),      # informational; EncDecLM owns layout
        norm="layernorm",
        activation="gelu",
        mlp_gated=False,
        use_rope=False,                  # sinusoidal absolute positions
        qkv_bias=True,
        is_encdec=True,
        encoder_layers=24,
        encoder_len=1500,
    )
