"""Set-up: from the start of the process to the start of the window
(imports, kernel builds on a first run, weights, inputs, the first checked
steps or the warm-up of every length)."""


def read(run, phase=None):
    return run.setup_s
