"""build(config) -> model object; port of ``repro/arch/model_zoo.py``.

Every architecture of ``configs/registry.py`` builds: the encoder-decoder
family as an :class:`EncDecModel`, every other family as a decoder-only
:class:`Model`."""

from __future__ import annotations

from repro_torch.arch.encdec import EncDecModel
from repro_torch.arch.transformer import Model
from repro_torch.configs.base import ModelConfig


def build(cfg: ModelConfig) -> Model | EncDecModel:
    if cfg.family == "encdec":
        return EncDecModel(cfg)
    return Model(cfg)
