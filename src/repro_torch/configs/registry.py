"""Architecture registry — resolves ``--arch`` to a ``ModelConfig``.

The same ten architectures, under the same names, as the JAX package's
``configs/registry.py``.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.configs import (
    deepseek_7b,
    grok1_314b,
    hymba_1_5b,
    llama4_maverick_400b_a17b,
    llava_next_34b,
    mamba2_130m,
    musicgen_medium,
    qwen2_1_5b,
    qwen2_5_32b,
    starcoder2_3b,
)
from repro_torch.configs.base import ModelConfig

ARCHS: Dict[str, ModelConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (
        qwen2_5_32b,
        deepseek_7b,
        qwen2_1_5b,
        starcoder2_3b,
        llama4_maverick_400b_a17b,
        grok1_314b,
        musicgen_medium,
        llava_next_34b,
        mamba2_130m,
        hymba_1_5b,
    )
}


def get_arch(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]
