"""Assigned architecture configs (exact public-literature dimensions) and
reduced smoke variants: copies of :mod:`repro.configs` over the port's
:class:`~repro_torch.models.config.ModelConfig`.

Usage: ``repro_torch.configs.get("qwen3-8b")`` /
``get_smoke("qwen3-8b")``; ``names()`` lists all ten.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, List

from repro_torch.models.config import ModelConfig

_MODULES = [
    "whisper_tiny", "pixtral_12b", "qwen3_8b", "yi_9b", "yi_34b",
    "minitron_8b", "qwen3_moe_30b_a3b", "grok_1_314b", "mamba2_1_3b",
    "zamba2_7b",
]

CONFIGS: Dict[str, ModelConfig] = {}
SMOKE_CONFIGS: Dict[str, ModelConfig] = {}

for _m in _MODULES:
    mod = importlib.import_module(f"repro_torch.configs.{_m}")
    CONFIGS[mod.CONFIG.name] = mod.CONFIG
    SMOKE_CONFIGS[mod.CONFIG.name] = mod.SMOKE


def names() -> List[str]:
    return list(CONFIGS)


def get(name: str) -> ModelConfig:
    return CONFIGS[name]


def get_smoke(name: str) -> ModelConfig:
    return SMOKE_CONFIGS[name]
