"""decode_occupancy (%): live slots per decode step over ``max_batch``,
over every decode step of the window (the engine's per-step timeline
entry).  Layer: scheduler.  Moves: output_tok_s."""


def read(run):
    dec = [s for s in run["steps"] if s.kind == "decode"]
    if not dec:
        return None
    return 100.0 * sum(s.live for s in dec) / (run["max_batch"] * len(dec))
