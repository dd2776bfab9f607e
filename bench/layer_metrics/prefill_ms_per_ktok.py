"""prefill_ms_per_ktok (ms): the harness's clock around every prefill
``step()`` of the window, over the prompt tokens they prefilled, per
1,000 tokens.  Layer: engine step.  Moves: ttft_p95_ms."""

from harness import drive


def read(run):
    return drive.prefill_ms_per_ktok(run["steps"])
