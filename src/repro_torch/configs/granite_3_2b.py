"""granite-3-2b — IBM Granite 3.0 2B base.

[hf:ibm-granite/granite-3.0-2b-base; hf]  dense, GQA.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="granite-3-2b",
    family="dense",
    num_layers=40,
    d_model=2048,
    num_heads=32,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=49155,
    d_head=64,
    rope_theta=10000.0,
    activation="swiglu",
    tie_embeddings=True,
    subquadratic=False,
    source="hf:ibm-granite/granite-3.0-2b-base",
)
