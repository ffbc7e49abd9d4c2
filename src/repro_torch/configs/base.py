"""Model/run configuration for the architecture zoo."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, replace
from typing import Any


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # dense | hybrid | ssm | audio | vlm | moe
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0                 # 0 => d_model // n_heads

    # repeating layer pattern; each inner tuple is one layer's sub-layers
    pattern: tuple[tuple[str, ...], ...] = (("attn", "mlp"),)

    norm: str = "rmsnorm"             # rmsnorm | layernorm
    norm_eps: float = 1e-6            # RMSNorm's epsilon
    activation: str = "gelu"
    mlp_gated: bool = True
    rope_theta: float = 10000.0
    use_rope: bool = True
    qkv_bias: bool = False
    window: int | None = None         # sliding window for 'attn_local'
    attn_softcap: float | None = None
    final_softcap: float | None = None
    query_pre_attn_scalar: float | None = None
    embed_scale: bool = False         # gemma: embeddings *= sqrt(d_model)
    post_block_norm: bool = False     # gemma2 extra post-norms

    # MoE
    moe_experts: int = 0
    moe_top_k: int = 0
    moe_shared_dff: int = 0           # fused shared-expert width (0 = none)
    moe_group_size: int = 512
    moe_capacity_factor: float = 1.25
    moe_impl: str = "sort"            # "sort" (optimised) | "onehot" (GShard)

    # SSM / xLSTM
    ssm_state: int = 64
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 128
    shared_attn_period: int = 0       # zamba2: shared attn every N layers
    ssm_groups: int = 1               # Mamba-2 groups of heads sharing B, C
    ssm_gate_before_norm: bool = False  # norm(y * silu(z)) per group
    # dt_bias held as the offset from Mamba-2's initial one: softplus^-1 of
    # dt log-spaced over the heads across this (time_step_min, _max) range
    ssm_dt_range: tuple[float, float] | None = None
    # shared blocks before the layers at these positions (not a period):
    # application k runs block k % n_shared_blocks over concat(x, embedding),
    # adds its own LoRA of shared_adapter_rank to the MLP's gate and up
    # projections and its own d x d output linear, and its output joins the
    # next layer's input, not the residual
    hybrid_layer_ids: tuple[int, ...] = ()
    n_shared_blocks: int = 1
    shared_adapter_rank: int = 0

    # encoder-decoder (whisper)
    is_encdec: bool = False
    encoder_layers: int = 0
    encoder_len: int = 1500

    # VLM
    n_img_tokens: int = 0

    # execution
    remat: bool = True
    scan_layers: bool = True
    unroll_scans: bool = False        # costing variants only (dryrun.py)
    q_chunk: int = 512
    loss_seq_chunk: int | None = 1024
    sub_quadratic: bool = False       # eligible for long_500k

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        assert self.n_layers % len(self.pattern) == 0, \
            (self.name, self.n_layers, len(self.pattern))

    @property
    def n_groups(self) -> int:
        if self.shared_attn_period:
            return self.n_layers // self.shared_attn_period
        return self.n_layers // len(self.pattern)

    @property
    def n_shared_applications(self) -> int:
        """Applications of the shared block(s) per pass: one per hybrid
        position, or one per group of ``shared_attn_period`` layers."""
        if self.hybrid_layer_ids:
            return len(self.hybrid_layer_ids)
        return self.n_groups if self.shared_attn_period else 0

    @property
    def group_kinds(self) -> tuple[str, ...]:
        """Flattened sub-layer kinds of one scan group."""
        if self.shared_attn_period:
            # zamba2-style: N backbone layers then the shared block (params
            # live outside the scan; the cache entry is per-group)
            per_layer = tuple(k for layer in self.pattern for k in layer)
            return per_layer * self.shared_attn_period
        return tuple(k for layer in self.pattern for k in layer)

    def params_estimate(self) -> float:
        """Approximate parameter count (for roofline MODEL_FLOPS)."""
        d, f, v = self.d_model, self.d_ff, self.vocab
        kinds = self.group_kinds
        per_group = 0.0
        for k in kinds:
            if k in ("attn", "attn_local"):
                per_group += d * self.head_dim * (self.n_heads * 2
                                                  + self.n_kv_heads * 2)
            elif k == "mlp":
                per_group += d * f * (3 if self.mlp_gated else 2)
            elif k == "moe":
                per_group += (self.moe_experts * 3 * d * f
                              + (3 * d * self.moe_shared_dff))
            elif k == "mamba2":
                d_in = self.ssm_expand * d
                per_group += d * (2 * d_in
                                  + 2 * self.ssm_groups * self.ssm_state
                                  + d_in // self.ssm_head_dim) + d_in * d
            elif k == "mlstm":
                d_in = 2 * d
                per_group += d * 2 * d_in + 3 * d_in * d_in + d_in * d
            elif k == "slstm":
                per_group += 4 * d * d + 2 * d * int(4 * d / 3) * 2
        total = per_group * self.n_groups + v * d
        if self.shared_attn_period:
            total += d * self.head_dim * (self.n_heads * 2
                                          + self.n_kv_heads * 2) + 3 * d * f
        if self.hybrid_layer_ids:
            d_attn = 2 * d                   # over concat(x, embedding)
            block = (d_attn * self.head_dim * (self.n_heads
                                               + 2 * self.n_kv_heads)
                     + self.n_heads * self.head_dim * d + 3 * d * f)
            per_app = d * d + self.shared_adapter_rank * (d + 2 * f)
            total += (block * self.n_shared_blocks
                      + per_app * self.n_shared_applications)
        if self.is_encdec:
            # encoder layers + decoder cross-attn (rough)
            total += self.encoder_layers * (4 * d * d + 2 * d * f)
            total += self.n_layers * 4 * d * d
        return total

    def replace(self, **kw) -> "ModelConfig":
        return replace(self, **kw)


@dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: str                         # train | prefill | decode

    @property
    def is_serve(self) -> bool:
        return self.kind in ("prefill", "decode")


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "decode")

ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)


def shape_by_name(name: str) -> ShapeConfig:
    for s in ALL_SHAPES:
        if s.name == name:
            return s
    raise KeyError(name)
