"""device_idle_share (%): the share of the traced stretch in which no
kernel or copy ran on the device (``torch.profiler``).  Layer: device.
Moves: output_tok_s."""


def read(run):
    tr = run["trace"]
    if tr is None or tr["busy_s"] <= 0 or tr["span_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["span_s"])
