"""qwen2-vl-2b — Qwen2-VL 2B backbone (M-RoPE, dynamic-resolution vision).

[arXiv:2409.12191; hf]  Transformer backbone only; the ViT patch frontend is a
stub — ``input_specs()`` supplies precomputed patch embeddings.  M-RoPE splits
head_dim rotary sections across (temporal, height, width) position ids.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen2-vl-2b",
    family="vlm",
    num_layers=28,
    d_model=1536,
    num_heads=12,
    num_kv_heads=2,
    d_ff=8960,
    vocab_size=151936,
    d_head=128,
    rope_theta=1_000_000.0,
    mrope_sections=(16, 24, 24),   # t/h/w rotary sections (sum = d_head/2)
    activation="swiglu",
    tie_embeddings=True,
    frontend="vision_patches",
    subquadratic=False,
    source="arXiv:2409.12191",
)
