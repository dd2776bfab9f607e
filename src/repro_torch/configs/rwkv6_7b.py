"""rwkv6-7b — RWKV-6 "Finch" (attention-free, data-dependent decay).

[arXiv:2404.05892; hf]  32L, d_model=4096, 64 time-mix heads of dim 64,
channel-mix FFN d_ff=14336 (squared-ReLU).
"""

from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    arch_id="rwkv6-7b",
    family="ssm",
    num_layers=32,
    d_model=4096,
    num_heads=64,                  # time-mix heads
    num_kv_heads=64,
    d_ff=14336,
    vocab_size=65536,
    d_head=64,
    activation="relu_sq",          # RWKV channel-mix uses squared ReLU
    ssm=SSMConfig(d_state=64, head_dim=64, num_ssm_heads=64),
    subquadratic=True,             # recurrent state, O(1) in sequence length
    source="arXiv:2404.05892",
)
