"""Tokens of all the training steps completed in the window over the
window's time (host clock, from its start to the end of its last step on
the device)."""


def read(run, phase=None):
    return run.tokens / run.window_s if run.kind == "train" else None
