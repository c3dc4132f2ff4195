"""Architecture / shape registry — resolves ``--arch`` and ``--shape``.

The same ten architectures and four shapes, under the same names, as the
JAX package's ``configs/registry.py``.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

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
from repro_torch.configs.base import ALL_SHAPES, SHAPES, ModelConfig, ShapeConfig

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


def get_shape(name: str) -> ShapeConfig:
    if name not in SHAPES:
        raise KeyError(f"unknown shape {name!r}; known: {sorted(SHAPES)}")
    return SHAPES[name]


def cell_is_runnable(arch: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Whether an (arch × shape) cell is defined.

    ``long_500k`` needs sub-quadratic attention / O(1) decode state — it is
    skipped (documented N/A) for pure full-attention archs.
    """
    if shape.name == "long_500k" and not arch.supports_long_context:
        return False, "long_500k skipped: full-attention arch (quadratic/unbounded KV)"
    return True, ""


def all_cells(include_skipped: bool = False) -> List[Tuple[ModelConfig, ShapeConfig, bool, str]]:
    out = []
    for arch in ARCHS.values():
        for shape in ALL_SHAPES:
            ok, why = cell_is_runnable(arch, shape)
            if ok or include_skipped:
                out.append((arch, shape, ok, why))
    return out
