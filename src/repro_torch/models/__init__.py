"""Model graphs of the port: the paper's 18 CNNs (``cnn_zoo``), the
decoder-only LMs (``lm``: dense, MoE, Mamba-2 hybrid, xLSTM, VLM backbone)
and the encoder-decoder (``encdec``), built from the configs by
``registry``."""

from . import cnn_zoo
from .encdec import EncDecLM
from .lm import DecoderLM
from .registry import build_model, config_names, get_config, register

__all__ = ["DecoderLM", "EncDecLM", "build_model", "cnn_zoo",
           "config_names", "get_config", "register"]
