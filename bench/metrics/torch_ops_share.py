"""Share of the device's time in the window spent in work that is neither
one of the port's kernels K1-K4 (forward or backward, by symbol) nor
launched inside ``optimizer.step``: torch's own kernels and copies."""


def read(run, phase=None):
    t = run.trace
    if t is None or run.kind != phase or not t.device_ns:
        return None
    own = sum(t.kernel_ns.values()) + t.range_ns["optimizer.step"]
    return 100.0 * (t.device_ns - own) / t.device_ns
