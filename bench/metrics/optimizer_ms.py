"""Device ms a training step of the work launched inside the program's
``optimizer.step`` range (``train/steps.py``)."""


def read(run, phase=None):
    if run.trace is None or run.kind != "train" or not run.steps:
        return None
    ns = run.trace.range_ns["optimizer.step"]
    return ns / 1e6 / run.steps if ns else None
