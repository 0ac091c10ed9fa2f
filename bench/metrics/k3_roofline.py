"""K3 (``kernels/ssd_scan.py``): the least time of the chunk scans the
window's passes need (a forward a layer a pass, and in training the
backward), each the larger of its bytes over 3.35 TB/s and its operations
over 989 TFLOP/s (``yardstick.bounds``), over the device time of every K3
launch (forward, its recompute under remat, backward)."""
import torch

from bench.yardstick.bounds import least_ms, ssd_bound_parts_ms, ssd_bwd_bound_parts_ms


def read(run, phase=None):
    t = run.trace
    if t is None or run.kind != phase or not t.kernel_ns["k3"]:
        return None
    c = run.conf
    h, p = c["expand"] * c["d_model"] // c["headdim"], c["headdim"]
    args = (h, p, c["ngroups"], c["d_state"], c["chunk_size"], torch.bfloat16)
    ms = 0.0
    for rows, seq, train in run.passes:
        one = least_ms(ssd_bound_parts_ms(rows, seq, *args))
        if train:
            one += least_ms(ssd_bwd_bound_parts_ms(rows, seq, *args))
        ms += one * c["n_layer"]
    return 100.0 * ms * 1e6 / t.kernel_ns["k3"]
