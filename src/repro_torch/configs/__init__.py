"""Architecture registry of the port: the MoE configurations its serving
path runs (``deepseek-r1``, the paper's evaluation model, and
``kimi-k2-1t-a32b``, which the MoE tests also use)."""

from __future__ import annotations

from typing import Dict

from repro_torch.configs import deepseek_r1, kimi_k2_1t_a32b
from repro_torch.configs.base import ModelConfig, MoEConfig

REGISTRY: Dict[str, ModelConfig] = {
    m.CONFIG.arch_id: m.CONFIG for m in (deepseek_r1, kimi_k2_1t_a32b)
}


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r}; have {sorted(REGISTRY)}")
    return REGISTRY[arch_id]


__all__ = ["ModelConfig", "MoEConfig", "REGISTRY", "get_config"]
