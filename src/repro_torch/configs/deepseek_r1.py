"""deepseek_r1 — DeepSeek-R1 671B (the EAAS paper's evaluation model).

[arXiv:2412.19437 / 2501.12948]  61L, 256 routed experts top-8 + 1 shared,
first 3 layers dense, sigmoid gating.  NOTE: DeepSeek uses MLA attention; this
substrate models attention as GQA (kv=8) of matched KV-cache footprint — the
EAAS technique concerns the MoE/FFN tier, which is reproduced exactly.
This config is *additional* to the 10 assigned archs (used by the paper-figure
benchmarks); it is not one of the 40 graded dry-run cells.
"""

from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    arch_id="deepseek-r1",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=128,
    num_kv_heads=8,
    d_ff=2048,
    vocab_size=129280,
    d_head=64,
    rope_theta=10000.0,
    activation="swiglu",
    moe=MoEConfig(
        num_experts=256,
        top_k=8,
        d_expert=2048,
        num_shared_experts=1,
        first_k_dense=3,
        router_score_fn="sigmoid",
        normalize_topk=True,
    ),
    subquadratic=False,
    source="arXiv:2412.19437",
)
