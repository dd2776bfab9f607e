"""itl_p95_ms (ms): the 95th percentile of every gap between consecutive
tokens of a request that ends inside the window; a request still decoding
at the window's end adds its open gap, up to the end (the harness's
clock)."""

from harness import drive
from harness.frozen import percentile


def read(run):
    p = percentile(drive.itls(run["tracks"], run["ws"], run["we"]), 95)
    return None if p is None else 1000.0 * p
