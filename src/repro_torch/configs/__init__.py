"""Assigned-architecture configs.  Importing this package registers all of
them with repro_torch.models.registry."""

from . import (gemma2_9b, starcoder2_15b, gemma_7b, granite_8b, zamba2_2p7b,
               zamba2_7b, xlstm_125m, whisper_medium, internvl2_76b,
               qwen2_moe_a2p7b, granite_moe_3b_a800m)
from .base import (ModelConfig, ShapeConfig, TRAIN_4K, PREFILL_32K,
                   DECODE_32K, LONG_500K, ALL_SHAPES, shape_by_name)

__all__ = ["ModelConfig", "ShapeConfig", "TRAIN_4K", "PREFILL_32K",
           "DECODE_32K", "LONG_500K", "ALL_SHAPES", "shape_by_name"]
