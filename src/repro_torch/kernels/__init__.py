"""Hand-written Hopper kernels, their plain PyTorch versions, and the
block-size autotuner.  Nothing here builds or loads a CUDA library at import
time: ``_build`` compiles the sources at the first launch on the card.

The kernel entry points are ``ops.flash_attention`` and ``ops.ssd_scan``;
the submodules ``flash_attention`` and ``ssd_scan`` hold each kernel's
wrapper and its ``launches`` counter.
"""

from .ops import flash_attention_node, smem_footprint, ssd_scan_node
from .substrate import (DEFAULT_CANDIDATES, DEFAULT_PARAMS, KernelAutotuner,
                        TuneRecord)

__all__ = [
    "flash_attention_node", "ssd_scan_node", "smem_footprint",
    "DEFAULT_CANDIDATES", "DEFAULT_PARAMS", "KernelAutotuner", "TuneRecord",
]
