"""Weight bridge: the reference's params pytree -> the port's params.

The port keeps the reference's parameter keys and layouts, so the bridge is
a tree map from numpy leaves (the caller converts the JAX arrays with
``np.asarray``) to tensors.  With bridged params both packages compute the
same function, which is what the parity tests rely on: ``jax.random``
initialisation cannot be reproduced in torch.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig


def tensor_from_numpy(a: np.ndarray, device) -> torch.Tensor:
    """numpy -> tensor; ml_dtypes bfloat16 goes through its uint16 bits
    (``torch.from_numpy`` refuses the ml_dtypes type)."""
    a = np.array(a)                   # own, writable, C-contiguous copy
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def params_from_numpy(tree: Dict, cfg: ModelConfig, device) -> Dict:
    """Map a params tree of numpy leaves onto ``device``.  ``cfg`` names
    the architecture whose layout the tree must have."""
    if "embed" not in tree or tree["embed"].shape != (cfg.padded_vocab,
                                                      cfg.d_model):
        raise ValueError(f"not a {cfg.arch_id} params tree")

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        return tensor_from_numpy(np.asarray(node), device)

    return conv(tree)
