"""minitron-8b — NVIDIA Minitron 8B (pruned Nemotron-4 15B).

[arXiv:2407.14679; hf]  dense, GQA kv=8.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="minitron-8b",
    family="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=16384,
    vocab_size=256000,
    d_head=128,
    rope_theta=10000.0,
    activation="relu_sq",          # Nemotron uses squared-ReLU MLPs
    subquadratic=False,
    source="arXiv:2407.14679",
)
