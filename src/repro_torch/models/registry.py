"""Architecture registry: config name -> (config, model), the port of
``repro/models/registry.py``."""

from __future__ import annotations

from typing import TYPE_CHECKING, Callable

import torch

from .lm import DecoderLM

if TYPE_CHECKING:  # avoid a circular import at runtime (configs import us)
    from repro_torch.configs.base import ModelConfig

_CONFIGS: dict[str, Callable[[], "ModelConfig"]] = {}


def register(name: str):
    def deco(fn):
        _CONFIGS[name] = fn
        return fn
    return deco


def _ensure_loaded():
    # configs register themselves on import
    import repro_torch.configs  # noqa: F401


def config_names() -> list[str]:
    _ensure_loaded()
    return sorted(_CONFIGS)


def get_config(name: str) -> "ModelConfig":
    _ensure_loaded()
    return _CONFIGS[name]()


def build_model(cfg, device: str | torch.device = "cuda") -> DecoderLM:
    """The model of ``cfg`` on ``device``.  Encoder-decoder configs wait for
    the port of ``encdec.py`` (ROADMAP.md Queue 1)."""
    if cfg.is_encdec:
        raise NotImplementedError(
            f"{cfg.name}: the encoder-decoder LM is not ported to repro_torch "
            "yet (ROADMAP.md Queue 1)")
    return DecoderLM(cfg, device)
