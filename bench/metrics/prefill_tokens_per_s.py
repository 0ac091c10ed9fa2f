"""Prompt tokens of all the batches completed in the window (every first
token on the host) over the window's time (host clock)."""


def read(run, phase=None):
    return run.tokens / run.window_s if run.kind == "prefill" else None
