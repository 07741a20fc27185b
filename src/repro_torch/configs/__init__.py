"""Architecture registry of the port: --arch <id> → (full CONFIG, SMOKE).

Every architecture of the reference registry: the dense, MoE, vlm, ssm,
hybrid and encdec families.
"""

from __future__ import annotations

import importlib
from typing import Dict, List, Tuple

from repro_torch.configs.base import (  # noqa: F401
    LONG_CONTEXT_FAMILIES, SHAPES, ModelConfig, ShapeSpec, shape_applicable,
    torch_dtype,
)

# the reference's order, so ``ARCH_IDS`` and ``all_cells`` list alike
_MODULES: Dict[str, str] = {
    "pixtral-12b": "pixtral_12b",
    "llama3.2-3b": "llama3_2_3b",
    "llama3.2-1b": "llama3_2_1b",
    "llama3-405b": "llama3_405b",
    "qwen1.5-4b": "qwen1_5_4b",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b",
    "jamba-v0.1-52b": "jamba_v0_1_52b",
    "rwkv6-3b": "rwkv6_3b",
    "whisper-large-v3": "whisper_large_v3",
}

ARCH_IDS: List[str] = list(_MODULES)


def _module(name: str):
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; available: {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_smoke_config(name: str) -> ModelConfig:
    return _module(name).SMOKE


def all_cells() -> List[Tuple[str, str]]:
    """Every assigned (arch × shape) cell, including to-be-skipped ones."""
    return [(a, s) for a in ARCH_IDS for s in SHAPES]
