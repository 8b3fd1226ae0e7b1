"""Config registry: one module per assigned architecture (+ paper models).

``get_config(name)`` returns the full-size ``ArchConfig``;
``get_smoke_config(name)`` returns a reduced same-family config for CPU tests.

The port's copy of ``repro.configs``, its imports rewritten.
"""
from __future__ import annotations

from typing import Dict, List

from repro_torch.configs.base import (ArchConfig, MoEConfig, SSMConfig, ShapeSpec,
                                      SHAPES, LM_SHAPES, shape_applicable,
                                      TRAIN, PREFILL, DECODE)

from repro_torch.configs import (chameleon_34b, zamba2_2_7b, stablelm_3b, qwen3_14b,
                                 qwen2_0_5b, internlm2_1_8b, granite_moe_1b,
                                 granite_moe_3b, mamba2_130m, whisper_base,
                                 llama2_7b, opt_13b)

_MODULES = [chameleon_34b, zamba2_2_7b, stablelm_3b, qwen3_14b, qwen2_0_5b,
            internlm2_1_8b, granite_moe_1b, granite_moe_3b, mamba2_130m,
            whisper_base, llama2_7b, opt_13b]

CONFIGS: Dict[str, ArchConfig] = {m.CONFIG.name: m.CONFIG for m in _MODULES}
SMOKE_CONFIGS: Dict[str, ArchConfig] = {
    m.CONFIG.name: m.SMOKE for m in _MODULES}

#: The ten assigned architecture ids (paper-extra models excluded).
ASSIGNED: List[str] = [
    "chameleon-34b", "zamba2-2.7b", "stablelm-3b", "qwen3-14b", "qwen2-0.5b",
    "internlm2-1.8b", "granite-moe-1b-a400m", "granite-moe-3b-a800m",
    "mamba2-130m", "whisper-base",
]


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


def get_shape(name: str) -> ShapeSpec:
    return SHAPES[name]


__all__ = ["ArchConfig", "MoEConfig", "SSMConfig", "ShapeSpec", "SHAPES",
           "LM_SHAPES", "CONFIGS", "SMOKE_CONFIGS", "ASSIGNED", "get_config",
           "get_smoke_config", "get_shape", "shape_applicable",
           "TRAIN", "PREFILL", "DECODE"]
