"""Architecture registry of the port: all eleven configurations of the
reference — the MoE models (``deepseek-r1``, the paper's evaluation model;
``kimi-k2-1t-a32b``; ``arctic-480b`` with its dense residual), the dense
decoders (``gemma3-4b``'s local/global attention, ``granite-3-2b``,
``minitron-8b``'s squared ReLU, ``phi3-medium-14b``, ``qwen2-vl-2b``'s
M-RoPE backbone), the hybrid ``zamba2-2.7b`` (Mamba2 layers and one shared
attention block), the recurrent ``rwkv6-7b`` and the encoder-decoder
``whisper-base``.  Copies of the reference's configs with their ``source``
strings, the four assigned input shapes (:mod:`repro_torch.configs.shapes`)
and ``ASSIGNED_ARCHS``, the ten graded architectures in assignment
order."""

from __future__ import annotations

from typing import Dict, List

from repro_torch.configs import (arctic_480b, deepseek_r1, gemma3_4b,
                                 granite_3_2b, kimi_k2_1t_a32b, minitron_8b,
                                 phi3_medium_14b, qwen2_vl_2b, rwkv6_7b,
                                 whisper_base, zamba2_2_7b)
from repro_torch.configs.base import ModelConfig, MoEConfig, SSMConfig
from repro_torch.configs.shapes import (ALL_SHAPES, DECODE_32K, LONG_500K,
                                        PREFILL_32K, TRAIN_4K, InputShape,
                                        applicable, reduced_shape,
                                        shape_by_name)

ASSIGNED_ARCHS: List[str] = [
    "granite-3-2b",
    "gemma3-4b",
    "minitron-8b",
    "phi3-medium-14b",
    "arctic-480b",
    "kimi-k2-1t-a32b",
    "zamba2-2.7b",
    "whisper-base",
    "rwkv6-7b",
    "qwen2-vl-2b",
]

REGISTRY: Dict[str, ModelConfig] = {
    m.CONFIG.arch_id: m.CONFIG
    for m in (deepseek_r1, kimi_k2_1t_a32b, arctic_480b, gemma3_4b,
              granite_3_2b, minitron_8b, phi3_medium_14b, qwen2_vl_2b,
              zamba2_2_7b, rwkv6_7b, whisper_base)
}


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r}; have {sorted(REGISTRY)}")
    return REGISTRY[arch_id]


__all__ = [
    "ModelConfig", "MoEConfig", "SSMConfig", "InputShape",
    "ALL_SHAPES", "TRAIN_4K", "PREFILL_32K", "DECODE_32K", "LONG_500K",
    "ASSIGNED_ARCHS", "REGISTRY", "get_config", "shape_by_name",
    "applicable", "reduced_shape",
]
