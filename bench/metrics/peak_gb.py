"""The most device memory allocated at once during the window
(``torch.cuda.max_memory_allocated``, reset when the window opens), in
10^9 bytes."""


def read(run, phase=None):
    return run.window_peak_bytes / 1e9
