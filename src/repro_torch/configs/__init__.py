"""Config registry of the port: the dense and VLM architectures of
``repro.configs`` and mamba2-130m.

``get_config(name)`` returns the full-size ``ArchConfig``;
``get_smoke_config(name)`` returns the reduced config the CPU tests use.
The hybrid, MoE and audio architectures come with later slices.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.configs import (chameleon_34b, internlm2_1_8b, llama2_7b,
                                 mamba2_130m, opt_13b, qwen2_0_5b, qwen3_14b,
                                 stablelm_3b)
from repro_torch.configs.base import ArchConfig

_MODULES = [chameleon_34b, stablelm_3b, qwen3_14b, qwen2_0_5b,
            internlm2_1_8b, mamba2_130m, llama2_7b, opt_13b]

CONFIGS: Dict[str, ArchConfig] = {m.CONFIG.name: m.CONFIG for m in _MODULES}
SMOKE_CONFIGS: Dict[str, ArchConfig] = {
    m.CONFIG.name: m.SMOKE for m in _MODULES}


def get_config(name: str) -> ArchConfig:
    try:
        return CONFIGS[name]
    except KeyError:
        raise KeyError(f"unknown arch {name!r}; have {sorted(CONFIGS)}")


def get_smoke_config(name: str) -> ArchConfig:
    try:
        return SMOKE_CONFIGS[name]
    except KeyError:
        raise KeyError(f"unknown arch {name!r}; have {sorted(SMOKE_CONFIGS)}")
