"""ttft_p95_ms (ms): the 95th percentile, over every request due inside
the window, of its first token's time less its due time; a request with
no first token by the window's end counts with its wait so far (the
harness's clock).  An open loop's metric: offline work is all due at
once."""

from harness import drive
from harness.frozen import percentile


def read(run):
    if run["mix"]["kind"] != "open_loop":
        return None
    p = percentile(drive.ttfts(run["tracks"], run["ws"], run["we"]), 95)
    return None if p is None else 1000.0 * p
