"""Architecture registry of the port: --arch <id> → (full CONFIG, SMOKE).

Only the dense family is ported so far. The other architectures of the
reference registry raise ``NotImplementedError`` naming the later slice.
"""

from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import (  # noqa: F401
    SHAPES, ModelConfig, ShapeSpec, torch_dtype,
)

_MODULES: Dict[str, str] = {
    "llama3.2-3b": "llama3_2_3b",
    "llama3.2-1b": "llama3_2_1b",
    "llama3-405b": "llama3_405b",
    "qwen1.5-4b": "qwen1_5_4b",
}

# architectures of the reference registry whose families come later
_LATER = ("pixtral-12b", "deepseek-moe-16b", "llama4-maverick-400b-a17b",
          "jamba-v0.1-52b", "rwkv6-3b", "whisper-large-v3")

ARCH_IDS: List[str] = list(_MODULES)


def _module(name: str):
    if name in _LATER:
        raise NotImplementedError(
            f"{name}: only the dense family is ported so far; the other "
            f"families come in a later slice of the port")
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; available: {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_smoke_config(name: str) -> ModelConfig:
    return _module(name).SMOKE
