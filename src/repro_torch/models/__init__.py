"""Model substrate of the port: the uniform decoder with the EAAS MoE FFN,
its attention, KV cache, RoPE, MLP and norms."""
