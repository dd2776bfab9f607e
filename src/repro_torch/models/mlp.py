"""Dense FFN blocks (SwiGLU / GeLU / squared-ReLU)."""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.distributed import tensor_parallel as tpl
from repro_torch.models.common import activation_fn, dense_init, matmul


def init_mlp(d_model: int, d_ff: int, activation: str, dtype, device,
             generator, lead=()) -> Dict:
    """Weights ``(*lead, in, out)``; ``lead`` stacks layers.  SwiGLU has a
    gate; the other activations have only up and down, as in the
    reference."""
    p = {}
    if activation == "swiglu":
        p["w_gate"] = dense_init((*lead, d_model, d_ff), dtype, device,
                                 generator)
    else:
        activation_fn(activation)          # unknown names raise here
    p["w_up"] = dense_init((*lead, d_model, d_ff), dtype, device, generator)
    p["w_down"] = dense_init((*lead, d_ff, d_model), dtype, device, generator)
    return p


def mlp(params: Dict, x: torch.Tensor, activation: str,
        group=None) -> torch.Tensor:
    """The FFN; with ``group`` (the ``model`` axis's) tensor-parallel: this
    rank's columns of w_gate / w_up (``col``) and rows of w_down
    (``row``), the outputs summed over the group.  One device: float32
    rows against bfloat16 weights promote as in jnp (``matmul``)."""
    if group is not None:
        x = tpl.copy_to(x, group)
    if activation == "swiglu":
        g = F.silu(matmul(x, params["w_gate"]))
        h = g * matmul(x, params["w_up"])
    else:
        h = activation_fn(activation)(matmul(x, params["w_up"]))
    if group is not None:
        return tpl.row_linear(h, params["w_down"], group)
    return matmul(h, params["w_down"])
