"""step_mfu (%): the benchmark's own count of the useful operations of
every token the window's steps processed (``harness/flops.py``), over the
window's seconds, as a share of the card's bf16 peak.  Layer: model step.
Moves: output_tok_s."""

from harness.peaks import BF16_FLOPS


def read(run):
    ops = sum(s.flops for s in run["steps"])
    if ops <= 0:
        return None
    return 100.0 * ops / run["seconds"] / BF16_FLOPS
