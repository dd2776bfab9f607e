"""whisper-base — OpenAI Whisper base (encoder-decoder, conv frontend stubbed).

[arXiv:2212.04356; unverified]  The transformer backbone only; the mel/conv
frontend is a stub — ``input_specs()`` supplies precomputed frame embeddings
of shape (batch, 1500, d_model).
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="whisper-base",
    family="audio",
    num_layers=6,                  # decoder layers
    d_model=512,
    num_heads=8,
    num_kv_heads=8,
    d_ff=2048,
    vocab_size=51865,
    d_head=64,
    rope_theta=10000.0,            # (whisper uses learned/sinusoidal; backbone sub)
    activation="gelu",
    is_encoder_decoder=True,
    num_encoder_layers=6,
    encoder_seq_len=1500,
    frontend="audio_frames",
    tie_embeddings=True,
    subquadratic=False,
    source="arXiv:2212.04356",
)
