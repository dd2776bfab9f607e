"""phi3-medium-14b — Microsoft Phi-3 Medium.

[arXiv:2404.14219; unverified]  dense, RoPE + SwiGLU + GQA kv=10.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="phi3-medium-14b",
    family="dense",
    num_layers=40,
    d_model=5120,
    num_heads=40,
    num_kv_heads=10,
    d_ff=17920,
    vocab_size=100352,
    d_head=128,
    rope_theta=10000.0,
    activation="swiglu",
    subquadratic=False,
    source="arXiv:2404.14219",
)
