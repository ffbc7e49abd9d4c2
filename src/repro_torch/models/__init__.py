"""Model graphs of the port: the paper's 18 CNNs (``cnn_zoo``) and the
decoder-only LMs (``lm``, built from the configs by ``registry``)."""

from . import cnn_zoo
from .lm import DecoderLM
from .registry import build_model, config_names, get_config, register

__all__ = ["DecoderLM", "build_model", "cnn_zoo", "config_names",
           "get_config", "register"]
