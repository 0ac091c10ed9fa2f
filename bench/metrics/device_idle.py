"""Share of the traced window in which no kernel or copy runs on the
device (the union of kineto's device intervals)."""


def read(run, phase=None):
    t = run.trace
    if t is None or run.kind != phase or not t.window_ns:
        return None
    return 100.0 * (1.0 - t.busy_ns / t.window_ns)
