"""setup_s (s): from the process's start to the window's opening: the
imports, the weights, the engine, the warm-up of every shape the run's
traffic uses and the span of that traffic served before the window."""


def read(run):
    return run["setup_s"]
