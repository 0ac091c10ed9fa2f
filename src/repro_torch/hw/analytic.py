"""The exact analytical backend: ``simulator.simulate_batch`` behind the
``CostBackend`` protocol.

This is the default substrate of every ``EvaluationEngine`` — records are
ground truth (cycle/energy/area model, full validity rules) and
bitwise-identical to the legacy per-candidate ``simulate_safe`` loop, so
the engine's looped reference path and the store round-trip guarantees
keep holding. It is stateless: one process-wide instance (``ANALYTIC``)
serves every engine, and its identity token is the namespace-compatible
default (engines treat it as the unmarked backend, so records written by
pre-backend versions of the store stay servable).
"""
from __future__ import annotations

from typing import Sequence

from repro_torch.core import simulator
from repro_torch.hw.backend import CostBackend, HwMetrics


class AnalyticBackend(CostBackend):
    """Full-fidelity cycle/energy/area model (see module docstring)."""

    name = "analytic"
    fidelity = "exact"
    exact = True
    metrics = ("latency_ms", "energy_mj", "area_mm2")

    def cache_key(self) -> str:
        return "analytic"

    def estimate_batch(
        self,
        specs: Sequence,
        hs: Sequence,
        batch: int = 1,
        vecs=None,
        accs=None,
    ) -> HwMetrics:
        records = simulator.simulate_batch(list(specs), list(hs), batch=batch)
        return HwMetrics(records=records, fidelity=self.fidelity)


#: the process-wide default backend (stateless, safe to share)
ANALYTIC = AnalyticBackend()
