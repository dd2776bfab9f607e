"""output_tok_s (tokens/s): every output token emitted inside the window,
first tokens included, over the window's seconds (the harness's clock)."""

from harness import drive


def read(run):
    return drive.output_tokens(run["tracks"], run["ws"], run["we"]) \
        / run["seconds"]
