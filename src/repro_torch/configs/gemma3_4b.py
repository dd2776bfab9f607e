"""gemma3-4b — Google Gemma 3 (5:1 local:global attention, 128k context).

[hf:google/gemma-3-1b-pt; unverified]  dense, GQA kv=4, sliding-window locals.

The 5:1 local:global pattern makes 5/6 of layers sliding-window (1024); KV for
local layers is bounded by the window, so the arch is treated as sub-quadratic
for the long_500k decode shape (global layers keep a full cache).
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="gemma3-4b",
    family="dense",
    num_layers=34,
    d_model=2560,
    num_heads=8,
    num_kv_heads=4,
    d_ff=10240,
    vocab_size=262144,
    d_head=256,
    rope_theta=1_000_000.0,
    sliding_window=1024,
    local_global_pattern=5,       # 5 local layers per 1 global layer
    attn_logit_softcap=None,
    tie_embeddings=True,
    activation="swiglu",
    max_seq_len=131072,
    subquadratic=True,
    source="hf:google/gemma-3-1b-pt",
)
