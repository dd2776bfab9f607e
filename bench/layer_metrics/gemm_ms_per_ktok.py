"""gemm_ms_per_ktok (ms): device time of the expert servers' grouped-GEMM
kernels (the bf16 route and the widening route, by kernel name) in the
traced stretch, per 1,000 tokens the stretch's steps processed (prompt
tokens prefilled and live rows decoded).  Layer: expert server and
kernels.  Moves: output_tok_s."""

from harness.trace import kernel_seconds

NAMES = ("grouped_gemm_bf16_kernel", "grouped_gemm_widen_kernel")


def read(run):
    sec = kernel_seconds(run["trace"], NAMES)
    tokens = sum(s.tokens for s in run["traced_steps"])
    if sec is None or not tokens:
        return None
    return 1000.0 * 1000.0 * sec / tokens
