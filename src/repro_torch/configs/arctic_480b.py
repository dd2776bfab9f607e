"""arctic-480b — Snowflake Arctic (dense-MoE hybrid: 128 experts top-2 with a
dense FFN residual running in parallel).

[hf:Snowflake/snowflake-arctic-base; hf]
"""

from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    arch_id="arctic-480b",
    family="moe",
    num_layers=35,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    d_ff=4864,
    vocab_size=32000,
    d_head=128,
    rope_theta=10000.0,
    activation="swiglu",
    moe=MoEConfig(
        num_experts=128,
        top_k=2,
        d_expert=4864,
        dense_residual=True,      # Arctic's signature dense+MoE parallel FFN
        router_score_fn="softmax",
        normalize_topk=True,
    ),
    subquadratic=False,
    source="hf:Snowflake/snowflake-arctic-base",
)
