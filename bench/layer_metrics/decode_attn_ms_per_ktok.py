"""decode_attn_ms_per_ktok (ms): device time of the port's decode
attention kernels (by name, below) in the traced stretch, per 1,000 rows
its decode steps decoded.  Prefill attention has no kernel of its own in
the port (float32 matmuls and a softmax that no name tells apart from the
rest of a prefill), so it is not counted.  Layer: attention and kernels.
Moves: output_tok_s."""

from harness.trace import kernel_seconds

NAMES = ("flash_decode_kernel", "paged_flash_decode_kernel")


def read(run):
    sec = kernel_seconds(run["trace"], NAMES)
    rows = sum(s.tokens for s in run["traced_steps"] if s.kind == "decode")
    if sec is None or not rows:
        return None
    return 1000.0 * 1000.0 * sec / rows
