"""Architecture registry of the port: the decoder configurations its
serving path runs — the MoE models (``deepseek-r1``, the paper's
evaluation model; ``kimi-k2-1t-a32b``; ``arctic-480b`` with its dense
residual) and the dense family (``gemma3-4b``'s local/global attention,
``granite-3-2b``, ``minitron-8b``'s squared ReLU, ``phi3-medium-14b``,
``qwen2-vl-2b``'s M-RoPE backbone).  Copies of the reference's configs
with their ``source`` strings; whisper, zamba2 and rwkv6 are not ported."""

from __future__ import annotations

from typing import Dict

from repro_torch.configs import (arctic_480b, deepseek_r1, gemma3_4b,
                                 granite_3_2b, kimi_k2_1t_a32b, minitron_8b,
                                 phi3_medium_14b, qwen2_vl_2b)
from repro_torch.configs.base import ModelConfig, MoEConfig

REGISTRY: Dict[str, ModelConfig] = {
    m.CONFIG.arch_id: m.CONFIG
    for m in (deepseek_r1, kimi_k2_1t_a32b, arctic_480b, gemma3_4b,
              granite_3_2b, minitron_8b, phi3_medium_14b, qwen2_vl_2b)
}


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r}; have {sorted(REGISTRY)}")
    return REGISTRY[arch_id]


__all__ = ["ModelConfig", "MoEConfig", "REGISTRY", "get_config"]
