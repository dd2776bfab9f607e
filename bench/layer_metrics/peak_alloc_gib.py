"""peak_alloc_gib (GiB): ``torch.cuda.max_memory_allocated()`` over the
set-up and the window.  Layer: device.  Moves: output_tok_s."""


def read(run):
    peak = run["peak_bytes"]
    return peak / 2 ** 30 if peak > 0 else None
