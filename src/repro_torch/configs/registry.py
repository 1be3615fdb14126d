"""--arch registry: the 10 assigned architectures (+ smoke variants).

One module per architecture under repro_torch/configs/ with the exact published
dims; this registry maps --arch ids to them.
"""

from __future__ import annotations

from repro_torch.configs import (
    deepseek_7b,
    gemma3_12b,
    granite_8b,
    granite_moe_1b,
    grok_1_314b,
    llava_next_34b,
    recurrentgemma_2b,
    rwkv6_1b6,
    smollm_360m,
    whisper_medium,
)
from repro_torch.configs.base import ModelConfig

_MODULES = (
    granite_8b, smollm_360m, deepseek_7b, gemma3_12b, rwkv6_1b6,
    whisper_medium, grok_1_314b, granite_moe_1b, llava_next_34b,
    recurrentgemma_2b,
)

ARCHS: dict[str, ModelConfig] = {m.config.name: m.config for m in _MODULES}


def get(name: str) -> ModelConfig:
    if name.endswith("-smoke"):
        return ARCHS[name[: -len("-smoke")]].smoke()
    return ARCHS[name]
