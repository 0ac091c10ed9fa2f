"""Model FLOPs of the work completed in the traced window
(``yardstick.flops``: 6·N·D for training, 2·N·D for prefill, no
recompute) over the device's busy time in it (the union of kineto's device
intervals) times the card's bf16 peak (989 TFLOP/s, NVIDIA's data sheet at
700 W; the run prints the card's power limit beside it). The whole step's
share of the peak while the device works: it bounds every kernel's
roofline share, and the device's idle share is ``device_idle``'s."""
import torch

from bench.yardstick.flops import model_flops
from bench.yardstick.peaks import PEAK_FLOP_PER_S


def read(run, phase=None):
    t = run.trace
    if t is None or run.kind != phase or not run.passes or not t.busy_ns:
        return None
    work = sum(model_flops(run.conf, rows, seq, train) for rows, seq, train in run.passes)
    return 100.0 * work / (t.busy_ns / 1e9 * PEAK_FLOP_PER_S[torch.bfloat16])
