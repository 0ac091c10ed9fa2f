"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates
at the 700 W limit): a frozen copy of ``HBM_BYTES_PER_S`` and
``PEAK_FLOP_PER_S`` from ``chip_smoke.py`` at commit cbce191."""
import torch

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOP_PER_S = {torch.float32: 67e12, torch.bfloat16: 989e12}
