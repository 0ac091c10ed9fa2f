"""Hardware cost backends (the ``CostBackend`` protocol).

One interface — ``estimate_batch(specs, hs, ...) -> HwMetrics`` — over the
exact analytical simulator (``AnalyticBackend``), the learned MLP cost
model (``LearnedBackend``), and the multi-fidelity cheap-filter-then-refine
cascade (``CascadeBackend``). The pod-level roofline adapter
(``repro_torch.hw.roofline.PodRooflineBackend``) lives in its own module,
as the reference's does, to keep this package import-light for the core
search stack.
"""
from repro_torch.hw.analytic import ANALYTIC, AnalyticBackend
from repro_torch.hw.backend import CostBackend, HwMetrics
from repro_torch.hw.cascade import CascadeBackend, CascadeStats
from repro_torch.hw.learned import LearnedBackend

__all__ = [
    "ANALYTIC",
    "AnalyticBackend",
    "CascadeBackend",
    "CascadeStats",
    "CostBackend",
    "HwMetrics",
    "LearnedBackend",
]
