"""Where the benchmark's tools find the checkout and its packages."""

import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def setup_path() -> None:
    sys.path[:0] = [str(BENCH), str(ROOT / "src")]
