"""Model configuration system (the port's own copy of the reference's
``configs/base.py``: the port imports nothing of the JAX package).

One :class:`ModelConfig` dataclass covers every assigned architecture family
(dense / moe / hybrid / ssm / audio / vlm).  Architecture files under
``repro_torch.configs`` instantiate it with the exact published
hyper-parameters and register themselves in the registry (see
``__init__.py``).

Every config also knows how to produce a *reduced* version of itself
(``cfg.reduced()``) used by the CPU smoke tests: same family and wiring, tiny
widths.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-Experts sub-config (present when the arch has MoE layers)."""

    num_experts: int
    top_k: int
    d_expert: int                       # hidden dim of each expert FFN
    num_shared_experts: int = 0         # DeepSeek-style always-on experts
    dense_residual: bool = False        # Arctic: dense FFN residual in parallel
    first_k_dense: int = 0              # leading dense layers (DeepSeek/Kimi)
    router_score_fn: str = "softmax"    # "softmax" | "sigmoid"
    normalize_topk: bool = True         # renormalize selected scores to sum 1
    capacity_factor: float = 1.25       # per-(client,server) buffer headroom
    router_aux_loss_coef: float = 0.001
    router_z_loss_coef: float = 0.0


@dataclass(frozen=True)
class SSMConfig:
    """State-space sub-config (mamba2 / rwkv6)."""

    d_state: int = 64
    d_conv: int = 4                     # mamba2 short conv width
    expand: int = 2                     # mamba2 d_inner = expand * d_model
    num_ssm_heads: int = 0              # mamba2 multi-head SSD (0 = derive)
    head_dim: int = 64


@dataclass(frozen=True)
class ModelConfig:
    """Complete architecture description (one per assigned arch)."""

    arch_id: str
    family: str                         # dense|moe|hybrid|ssm|audio|vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: Optional[int] = None        # default: d_model // num_heads

    # --- attention flavour ------------------------------------------------
    rope_theta: float = 10000.0
    sliding_window: Optional[int] = None        # local-attention window
    local_global_pattern: int = 0               # gemma3: N local per 1 global
    attn_logit_softcap: Optional[float] = None
    mrope_sections: Optional[Tuple[int, ...]] = None   # qwen2-vl (t,h,w)
    tie_embeddings: bool = False
    rms_norm_eps: float = 1e-6
    activation: str = "swiglu"                  # swiglu | gelu | relu_sq

    # --- family sub-configs -----------------------------------------------
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None

    # hybrid (zamba2): a shared attention block is interleaved every
    # `shared_block_every` mamba layers.
    shared_block_every: int = 0

    # encoder-decoder (whisper)
    is_encoder_decoder: bool = False
    num_encoder_layers: int = 0
    encoder_seq_len: int = 1500          # whisper: 30s of audio frames

    # modality frontend stub: "none" | "audio_frames" | "vision_patches"
    frontend: str = "none"

    # --- serving / distribution defaults ----------------------------------
    max_seq_len: int = 131072
    dtype: str = "bfloat16"
    # long_500k applicability: sub-quadratic attention available?
    subquadratic: bool = False

    # --- citations ----------------------------------------------------------
    source: str = ""

    # ------------------------------------------------------------------ API
    @property
    def head_dim(self) -> int:
        return self.d_head if self.d_head is not None else self.d_model // self.num_heads

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up so embedding/head shard over the model axis
        (multiple of 256 covers every production mesh).  Logits for padding
        slots are masked to -inf (models/transformer._logits)."""
        return (self.vocab_size + 255) // 256 * 256

    @property
    def is_moe(self) -> bool:
        return self.moe is not None

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    def moe_layer_ids(self) -> Tuple[int, ...]:
        """Indices of layers whose FFN is an MoE layer."""
        if self.moe is None:
            return ()
        return tuple(
            i for i in range(self.num_layers) if i >= self.moe.first_k_dense
        )

    def num_params(self) -> int:
        """Analytic total parameter count (embedding + blocks + head)."""
        d, h, kv, dh, ff, v = (
            self.d_model, self.num_heads, self.num_kv_heads,
            self.head_dim, self.d_ff, self.vocab_size,
        )
        emb = v * d if self.tie_embeddings else 2 * v * d
        attn = d * (h * dh) + 2 * d * (kv * dh) + (h * dh) * d
        ffn_dense = 3 * d * ff if self.activation == "swiglu" else 2 * d * ff
        total = emb
        n_layers = self.num_layers
        if self.family == "ssm":
            ssm = self.ssm or SSMConfig()
            d_in = ssm.expand * d
            tmix = 4 * d * d + d * d  # r,k,v,g,o projections (approx, rwkv6)
            cmix = 2 * d * ff // 1 if self.activation != "swiglu" else 2 * d * ff
            total += n_layers * (tmix + cmix)
            return total
        if self.family == "hybrid":
            ssm = self.ssm or SSMConfig()
            d_in = ssm.expand * d
            mamba = d * d_in * 2 + d_in * d + d_in * (2 * ssm.d_state)
            n_shared = (
                n_layers // self.shared_block_every if self.shared_block_every else 0
            )
            total += n_layers * (mamba + ffn_dense)
            total += (attn + ffn_dense)  # one shared block's params
            return total
        # transformer families
        enc_layers = self.num_encoder_layers if self.is_encoder_decoder else 0
        dec_layers = n_layers
        per_layer_dense = attn + ffn_dense
        if self.moe is not None:
            m = self.moe
            expert_ffn = (3 if self.activation == "swiglu" else 2) * d * m.d_expert
            per_moe = attn + m.num_experts * expert_ffn + d * m.num_experts
            per_moe += m.num_shared_experts * expert_ffn
            if m.dense_residual:
                per_moe += ffn_dense
            n_moe = len(self.moe_layer_ids())
            total += n_moe * per_moe + (dec_layers - n_moe) * per_layer_dense
        else:
            total += dec_layers * per_layer_dense
        total += enc_layers * (attn + ffn_dense)
        if self.is_encoder_decoder:
            total += dec_layers * attn  # cross-attention
        return total

    def num_active_params(self) -> int:
        """Parameters touched per token (MoE: only routed experts)."""
        if self.moe is None:
            return self.num_params()
        m = self.moe
        d, ff = self.d_model, m.d_expert
        expert_ffn = (3 if self.activation == "swiglu" else 2) * d * ff
        inactive = (m.num_experts - m.top_k) * expert_ffn
        return self.num_params() - len(self.moe_layer_ids()) * inactive

    # ------------------------------------------------------------- reduced
    def reduced(self) -> "ModelConfig":
        """Tiny same-family config for CPU smoke tests."""
        kw: dict = dict(
            arch_id=self.arch_id + "-reduced",
            family=self.family,
            num_layers=min(self.num_layers, 4 if self.shared_block_every == 0
                           else 2 * self.shared_block_every),
            d_model=128,
            num_heads=4,
            num_kv_heads=min(self.num_kv_heads, 2) if self.num_kv_heads < self.num_heads else 4,
            d_head=32,
            d_ff=256,
            vocab_size=512,
            rope_theta=self.rope_theta,
            sliding_window=64 if self.sliding_window else None,
            local_global_pattern=self.local_global_pattern,
            attn_logit_softcap=self.attn_logit_softcap,
            mrope_sections=(4, 6, 6) if self.mrope_sections else None,
            tie_embeddings=self.tie_embeddings,
            activation=self.activation,
            shared_block_every=self.shared_block_every,
            is_encoder_decoder=self.is_encoder_decoder,
            num_encoder_layers=min(self.num_encoder_layers, 2),
            encoder_seq_len=32,
            frontend=self.frontend,
            max_seq_len=1024,
            subquadratic=self.subquadratic,
            source=self.source,
        )
        if self.moe is not None:
            kw["moe"] = dataclasses.replace(
                self.moe,
                num_experts=8,
                top_k=min(self.moe.top_k, 2),
                d_expert=128,
                num_shared_experts=min(self.moe.num_shared_experts, 1),
                first_k_dense=min(self.moe.first_k_dense, 1),
            )
        if self.ssm is not None:
            kw["ssm"] = dataclasses.replace(
                self.ssm, d_state=16, head_dim=32, num_ssm_heads=4)
        return ModelConfig(**kw)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)
