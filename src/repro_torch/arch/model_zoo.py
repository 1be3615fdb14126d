"""build(config) -> model object; port of ``repro/arch/model_zoo.py``.

The port runs the dense decoder-only family, RWKV-6 and the hybrid family
(recurrentgemma); every other family raises ``NotImplementedError`` naming
the ROADMAP item that ports it."""

from __future__ import annotations

from repro_torch.arch.transformer import Model
from repro_torch.configs.base import ModelConfig


def build(cfg: ModelConfig) -> Model:
    return Model(cfg)
