"""decode_step_ms (ms): the harness's clock around every ``step()`` of the
window that decoded, total over count.  Layer: engine step.  Moves:
itl_p95_ms."""


def read(run):
    dec = [s for s in run["steps"] if s.kind == "decode"]
    if not dec:
        return None
    return 1000.0 * sum(s.t1 - s.t0 for s in dec) / len(dec)
