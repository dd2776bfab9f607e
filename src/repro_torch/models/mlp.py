"""Dense SwiGLU FFN (the only activation the ported configs use)."""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.models.common import dense_init


def init_mlp(d_model: int, d_ff: int, activation: str, dtype, device,
             generator, lead=()) -> Dict:
    """Weights ``(*lead, in, out)``; ``lead`` stacks layers."""
    if activation != "swiglu":
        raise NotImplementedError(f"activation {activation!r} is not ported")
    return {
        "w_gate": dense_init((*lead, d_model, d_ff), dtype, device, generator),
        "w_up": dense_init((*lead, d_model, d_ff), dtype, device, generator),
        "w_down": dense_init((*lead, d_ff, d_model), dtype, device, generator),
    }


def mlp(params: Dict, x: torch.Tensor, activation: str) -> torch.Tensor:
    if activation != "swiglu":
        raise NotImplementedError(f"activation {activation!r} is not ported")
    g = F.silu(x @ params["w_gate"])
    return (g * (x @ params["w_up"])) @ params["w_down"]
