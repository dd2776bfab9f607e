"""kimi-k2-1t-a32b — Kimi K2, trillion-parameter fine-grained MoE.

[arXiv:2501.kimi2; unverified]  61L, 384 experts top-8 + 1 shared expert,
first layer dense.  This is the paper's own Table-1 headline model family and
the primary target of the EAAS technique.
"""

from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    arch_id="kimi-k2-1t-a32b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=64,
    num_kv_heads=8,
    d_ff=2048,                     # expert hidden dim (fine-grained experts)
    vocab_size=163840,
    d_head=112,
    rope_theta=50000.0,
    activation="swiglu",
    moe=MoEConfig(
        num_experts=384,
        top_k=8,
        d_expert=2048,
        num_shared_experts=1,
        first_k_dense=1,           # K2: first layer dense
        router_score_fn="sigmoid",  # DeepSeek-V3-style sigmoid gating
        normalize_topk=True,
    ),
    subquadratic=False,
    source="arXiv:2501.kimi2",
)
