"""K4 (``kernels/gmm.py``): the least time of the expert products the
window's passes need, counted over the routed assignments (tokens x top-k),
not over the capacity buckets: three products a layer a pass forward, and
in training six more for their gradients; each the larger of its bytes
(the assignments' rows read and written once, the experts' weights read
once) over 3.35 TB/s and its operations over 989 TFLOP/s
(``yardstick.bounds``), over the device time of every K4 launch."""
import torch

from bench.yardstick.bounds import gmm_routed_parts_ms, least_ms


def read(run, phase=None):
    t = run.trace
    if t is None or run.kind != phase or not t.kernel_ns["k4"]:
        return None
    c = run.conf
    e, d, f = c["num_experts"], c["hidden_size"], c["moe_intermediate_size"]
    ms = 0.0
    for rows, seq, train in run.passes:
        a = rows * seq * c["num_experts_per_tok"]
        products = 9 if train else 3
        ms += products * least_ms(gmm_routed_parts_ms(a, e, d, f, torch.bfloat16))
    return 100.0 * ms * c["num_hidden_layers"] * 1e6 / t.kernel_ns["k4"]
