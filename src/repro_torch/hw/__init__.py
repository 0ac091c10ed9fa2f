"""Hardware cost backends (the ``CostBackend`` protocol).

One interface — ``estimate_batch(specs, hs, ...) -> HwMetrics`` — over the
exact analytical simulator (``AnalyticBackend``) and the learned-model
wrapper (``LearnedBackend``). The cascade and the pod roofline backends of
``repro.hw`` are not ported yet.
"""
from repro_torch.hw.analytic import ANALYTIC, AnalyticBackend
from repro_torch.hw.backend import CostBackend, HwMetrics
from repro_torch.hw.learned import LearnedBackend

__all__ = [
    "ANALYTIC",
    "AnalyticBackend",
    "CostBackend",
    "HwMetrics",
    "LearnedBackend",
]
