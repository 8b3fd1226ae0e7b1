"""Config registry of the port: llama2-7b and mamba2-130m, for now.

``get_config(name)`` returns the full-size ``ArchConfig``;
``get_smoke_config(name)`` returns the reduced config the CPU tests use.
The other architectures of ``repro.configs`` come with later slices.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.configs import llama2_7b, mamba2_130m
from repro_torch.configs.base import ArchConfig

_MODULES = [llama2_7b, mamba2_130m]

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
