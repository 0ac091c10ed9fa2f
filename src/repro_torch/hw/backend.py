"""The unified hardware cost-backend protocol.

Every hardware cost signal in the repo — the analytical cycle model
(``repro_torch.core.simulator``), the learned latency/area/energy MLP
(``repro_torch.core.costmodel``), the pod-level roofline model
(``repro_torch.launch.roofline`` via ``repro_torch.hw.roofline``), and the
multi-fidelity cascade (``repro_torch.hw.cascade``) — implements one interface:

    estimate_batch(specs, hs, batch=1, vecs=None, accs=None) -> HwMetrics

``specs``/``hs`` are the decoded (architecture, accelerator) candidates;
``vecs`` carries the encoded joint decision vectors when the caller
evaluates through symbolic spaces (learned backends featurize from them;
joint-only backends set ``joint_only`` so non-joint engines reject them
up front), and ``accs`` carries per-candidate accuracies when the backend
asked for them (``wants_accuracy`` — the cascade's dominance prefilter
needs the accuracy axis); ``accs`` may be a sequence or a lazy
``index -> accuracy`` callable, so backends that reject most candidates
cheaply only pay for the accuracies they read. ``HwMetrics`` is the batch
result: one metrics dict per
candidate (``None`` marks an invalid or pruned candidate — the validity
mask), plus the fidelity tag of the path that produced it.

Identity contract: a backend publishes ``cache_key()`` — a *content-based*
token describing everything that could change its estimates. The
``EvaluationEngine`` folds it into the record-store namespace
(``engine._identity_token``), which is what keeps a shared — possibly
durable — ``RecordStore`` sound across backends and across process
restarts: two engines share records iff their backends report the same
identity.

Fidelity tags:

* ``exact``   — the full analytical simulator; records are ground truth
  and have a per-candidate looped reference (``simulate_safe``).
* ``learned`` — MLP predictions (Sec. 3.5.2 "cost model in the loop");
  records carry ``predicted: True``.
* ``bound``   — the cascade's cheap lower-bound stage; never emitted as a
  record on its own, only used to rule candidates out.
* ``roofline`` — the pod-level three-term analytical model.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence


@dataclasses.dataclass
class HwMetrics:
    """One backend pass over a candidate batch.

    ``records[i]`` is the metrics dict for candidate ``i`` (the simulator
    schema: ``latency_ms``, ``energy_mj`` (may be ``None``), ``area_mm2``,
    optionally ``utilization`` and backend extras) or ``None`` when the
    candidate is invalid — or was pruned by a cheaper fidelity stage.
    """

    records: list
    fidelity: str

    @property
    def valid_mask(self) -> list:
        return [r is not None for r in self.records]

    @property
    def num_valid(self) -> int:
        return sum(1 for r in self.records if r is not None)

    def __len__(self) -> int:
        return len(self.records)

    def __iter__(self):
        return iter(self.records)


class CostBackend:
    """Base class / protocol for hardware cost backends (module docstring).

    Subclasses set the class attributes and implement ``estimate_batch``.
    ``metrics`` names the record keys the backend can serve — the engine
    rejects objectives that need a metric the backend cannot certify (an
    energy-target ``RewardConfig`` on a latency/area-only model).
    """

    name: str = "backend"
    fidelity: str = "exact"
    #: records have a per-candidate looped simulator reference
    exact: bool = False
    #: metric keys this backend serves with real values
    metrics: tuple = ("latency_ms", "area_mm2")
    #: ask the engine to pass per-candidate accuracies to estimate_batch
    wants_accuracy: bool = False

    def cache_key(self) -> str:
        """Content-based identity token (see module docstring). The default
        is the class name — right only for stateless backends."""
        return self.name

    def estimate_batch(
        self,
        specs: Sequence,
        hs: Sequence,
        batch: int = 1,
        vecs=None,
        accs=None,
    ) -> HwMetrics:
        raise NotImplementedError

    def estimate(self, spec, h, batch: int = 1) -> Optional[dict]:
        """Single-candidate convenience wrapper."""
        return self.estimate_batch([spec], [h], batch=batch).records[0]
