"""Scission ported to PyTorch and CUDA for one NVIDIA H100.

The JAX package ``repro`` stays the reference; this package mirrors its
paths (``repro/core/bench.py`` -> ``repro_torch/core/bench.py``) and imports
nothing of it or of JAX.  Entry points take an explicit ``device`` that
defaults to ``"cuda"``; the hand-written kernels under ``kernels/csrc`` are
built with ``nvcc`` at first use.
"""
