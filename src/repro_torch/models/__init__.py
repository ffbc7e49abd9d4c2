"""Model graphs of the port: the paper's 18 CNNs (``cnn_zoo``)."""

from . import cnn_zoo

__all__ = ["cnn_zoo"]
