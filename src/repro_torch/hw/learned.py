"""The learned backend: an MLP cost model behind the ``CostBackend``
protocol (paper Sec. 3.5.2, "cost model in the loop").

Wraps any predictor with the ``repro_torch.core.costmodel.CostModel`` surface:

* ``predict(feats (N, F)) -> (latency_ms (N,), area_mm2 (N,))`` — required;
* ``predict_all(feats) -> dict`` with an ``energy_mj`` array — optional
  (models trained with the energy head, ``costmodel.train(...,
  energy_mj=...)``); when present the backend also serves energy, so
  energy-target scenarios run on the learned path.

Features are the joint one-hot encoding of the (α, h) decision vector —
exactly what ``costmodel.generate_dataset`` labels — so the backend needs
the encoded ``vecs`` and the two spaces, and only joint-mode engines can
use it. The simulator's *static* validity rules (register file, minimum
memory, streaming bandwidth, PE aspect ratio) still apply — the controller
keeps receiving the invalid-config penalty — but the io-starvation rule
needs the full cycle model and is skipped. Records carry
``predicted: True``.

Identity: content-based when the wrapped model publishes a ``cache_key``;
otherwise process-local by model ``id()`` (a freshly trained model has no
stable content identity) — either way two engines wrapping the same model
share store records, and the engine pins the model against id reuse.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from repro_torch.core import simulator
from repro_torch.core.space import Space
from repro_torch.hw.backend import CostBackend, HwMetrics


class LearnedBackend(CostBackend):
    """MLP latency/area(/energy) predictions (see module docstring)."""

    name = "learned"
    fidelity = "learned"
    exact = False
    #: featurizes joint (α, h) vectors — engines in nas/has mode reject it
    joint_only = True

    def __init__(self, model, nas_space: Space, has_space: Space):
        if not callable(getattr(model, "predict", None)):
            raise ValueError(
                "LearnedBackend needs a predictor with "
                "predict(feats) -> (latency_ms, area_mm2)"
            )
        self.model = model
        self.nas_space = nas_space
        self.has_space = has_space
        self.has_energy = bool(getattr(model, "has_energy", False))
        if self.has_energy:
            self.metrics = ("latency_ms", "area_mm2", "energy_mj")
        else:
            self.metrics = ("latency_ms", "area_mm2")

    def cache_key(self) -> str:
        key = getattr(self.model, "cache_key", None)
        if callable(key):
            key = key()
        if key is None:
            key = f"id:{id(self.model)}"
        return f"{type(self.model).__name__}:{key}"

    def _features(self, vecs: np.ndarray) -> np.ndarray:
        """Joint one-hot features of the encoded (α, h) vectors."""
        na = self.nas_space.num_decisions
        rows = []
        for v in vecs:
            alpha = self.nas_space.features(v[:na])
            hw = self.has_space.features(v[na:])
            rows.append(np.concatenate([alpha, hw]))
        return np.stack(rows)

    def estimate_batch(
        self,
        specs: Sequence,
        hs: Sequence,
        batch: int = 1,
        vecs=None,
        accs=None,
    ) -> HwMetrics:
        if vecs is None:
            raise ValueError(
                "LearnedBackend featurizes from encoded decision vectors; "
                "evaluate through an EvaluationEngine (joint mode)"
            )
        feats = self._features(np.asarray(vecs))
        energy = None
        if self.has_energy:
            pred = self.model.predict_all(feats)
            lat, area = pred["latency_ms"], pred["area_mm2"]
            energy = pred["energy_mj"]
        else:
            lat, area = self.model.predict(feats)
        records: list = []
        for i, (spec, h) in enumerate(zip(specs, hs)):
            if simulator.validate(h, simulator.model_weight_bytes(spec)):
                records.append(None)
                continue
            rec = {
                "latency_ms": float(lat[i]),
                "area_mm2": float(area[i]),
                "energy_mj": None if energy is None else float(energy[i]),
                "utilization": None,
                "predicted": True,
            }
            records.append(rec)
        return HwMetrics(records=records, fidelity=self.fidelity)
