from .adamw import (AdamWConfig, apply_updates, clip_by_global_norm,
                    global_norm, init_state)
from .schedule import constant, cosine_with_warmup
from .compress import compressed_psum, dequantize, quantize, \
    tree_compressed_psum

__all__ = ["AdamWConfig", "apply_updates", "clip_by_global_norm",
           "global_norm", "init_state", "constant", "cosine_with_warmup",
           "compressed_psum", "dequantize", "quantize",
           "tree_compressed_psum"]
