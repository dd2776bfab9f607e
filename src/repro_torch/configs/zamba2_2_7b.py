"""zamba2-2.7b — Zyphra Zamba2 (Mamba2 backbone + shared attention block).

[arXiv:2411.15242; hf]  54 Mamba2 layers with a single *shared* transformer
block (attention + MLP) interleaved every 6 layers; ssm_state=64.
"""

from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    arch_id="zamba2-2.7b",
    family="hybrid",
    num_layers=54,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    d_ff=10240,
    vocab_size=32000,
    d_head=80,
    rope_theta=10000.0,
    activation="swiglu",
    ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_dim=64),
    shared_block_every=6,
    subquadratic=True,             # SSM state is O(1) in sequence length
    source="arXiv:2411.15242",
)
