"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at its 700 W limit)."""

BF16_FLOPS = 989e12        # FLOP/s on the tensor cores, bf16 / fp16
HBM_BYTES = 3.35e12        # bytes/s
