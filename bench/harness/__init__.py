"""The benchmark harness of ``repro_torch``: traffic, weights, the open
loop around ``ServingEngine``, the device trace, the FLOP count and the
check against the plain reference (``bench/reference``)."""
