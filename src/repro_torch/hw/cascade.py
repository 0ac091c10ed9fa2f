"""Multi-fidelity cascade: a vectorized lower-bound prefilter in front of an
expensive backend.

The semi-decoupled trick (Lu et al. 2022: prune the hardware space with a
cheap bound before exact evaluation): stage 1 computes, in O(N) vector
arithmetic, the static validity rules plus guaranteed *lower bounds* on
latency and energy and the exact chip area (``simulator.lower_bounds``);
stage 2 runs the wrapped full-fidelity backend only on the survivors. Two
prefilter rules, both conservative by construction:

* **scenario envelope** — a candidate whose optimistic bounds already
  violate some constraint of *every* scenario the cascade was built for
  can never be any of those scenarios' feasible pick; it is rejected
  without a full simulation. The scenario set is part of the backend's
  identity (``cache_key``), so records stay consistent inside a shared
  store namespace.
* **dominance** — a candidate whose (accuracy, latency-bound, energy-bound,
  area) is weakly dominated by an already-refined exact record can never
  join the Pareto frontier (its true metrics are dominated by the same
  incumbent), so ``frontier.best(scenario)`` is unchanged for every
  scenario — this is what makes the cascade *agree with the full backend
  on the selected best config per scenario* while running far fewer full
  simulations. Requires accuracies (``wants_accuracy``), which the engine
  supplies.

Pruned candidates surface as invalid records (``None`` in ``HwMetrics``),
so the search penalizes them exactly like simulator-invalid configs; the
per-stage counters in ``CascadeBackend.stats`` report how much each rule
saved. Caveats: the controller's reward stream differs from the exact
backend on pruned candidates (they score ``invalid_reward`` instead of a
soft penalty), so *trajectories* may diverge even though frontier picks
agree on any fixed candidate stream; and a scenario with no feasible
candidate at all falls back to frontier records the cascade may have
pruned. Dominance incumbents are per-instance and are NOT checkpointed:
a resumed cascade run restarts with empty incumbents, so — unlike the
analytic backend — resume is best-effort rather than bitwise-identical,
and which candidates a durable store records as pruned depends on arrival
order. Both stay sound for selection because within one run every
incumbent was also returned to the caller (so in-memory frontiers are
complete), and a durable store retains every refined record — read
cross-run frontiers off the store, which skips pruned markers and always
holds the dominating record.

Counterpart of ``repro/hw/cascade.py``, a copy: numpy over the port's
simulator and Pareto rules, so its records and stats are bitwise the
reference's. Only the store namespace differs, through the implementation
tag the port's engine adds (``engine.IMPL``).
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Optional, Sequence

import numpy as np

from repro_torch.core import simulator
from repro_torch.core.pareto import DEFAULT_OBJECTIVES, _canon, _dominates
from repro_torch.hw.analytic import ANALYTIC
from repro_torch.hw.backend import CostBackend, HwMetrics
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace


@dataclasses.dataclass
class CascadeStats:
    """Per-stage hit counters (all monotone)."""

    requested: int = 0
    static_invalid: int = 0   # rejected by the static validity rules
    envelope_pruned: int = 0  # bound violates every scenario's constraints
    dominance_pruned: int = 0  # bound dominated by a refined incumbent
    refined: int = 0          # candidates that reached the full backend
    refine_invalid: int = 0   # of those, rejected by the full backend
    batches: int = 0

    def __post_init__(self):
        obs_metrics.REGISTRY.register("cascade", self)

    @property
    def pruned(self) -> int:
        return self.static_invalid + self.envelope_pruned + self.dominance_pruned

    @property
    def prune_rate(self) -> float:
        return obs_metrics.rate(self.pruned, self.requested)

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["pruned"] = self.pruned
        d["prune_rate"] = self.prune_rate
        return d


class CascadeBackend(CostBackend):
    """Cheap-filter-then-refine over a full-fidelity backend (module doc).

    ``scenarios`` is the use-case set the envelope rule prunes against
    (anything ``repro_torch.core.scenarios.expand`` accepts; empty disables the
    rule). ``prune_dominated`` enables the incumbent-dominance rule.
    """

    name = "cascade"
    fidelity = "cascade"
    exact = False

    def __init__(
        self,
        refine: Optional[CostBackend] = None,
        scenarios=(),
        prune_dominated: bool = True,
    ):
        from repro_torch.core import scenarios as scenarios_lib

        self.refine = refine if refine is not None else ANALYTIC
        self.scenarios = ()
        if scenarios:
            self.scenarios = tuple(scenarios_lib.expand(scenarios))
        self.prune_dominated = prune_dominated
        self.metrics = self.refine.metrics
        self.wants_accuracy = prune_dominated
        self.stats = CascadeStats()
        # nondominated canon tuples of refined exact records (see pareto)
        self._incumbents: list = []
        self._lock = threading.Lock()

    def cache_key(self) -> str:
        ref = self.refine.cache_key()
        sc = ",".join(f"{s.name}:{s.describe()}" for s in self.scenarios)
        return f"cascade(refine={ref};scenarios=[{sc}];dom={self.prune_dominated})"

    # ---- prefilter stages -------------------------------------------------

    def _envelope_pruned(self, bounds: dict) -> np.ndarray:
        """True where the bound violates ≥1 constraint of EVERY scenario."""
        n = len(bounds["area_mm2"])
        if not self.scenarios:
            return np.zeros(n, bool)
        pruned = np.ones(n, bool)
        for s in self.scenarios:
            if s.energy_target_mj is not None:
                perf_bad = bounds["energy_mj"] > s.energy_target_mj
            else:
                perf_bad = bounds["latency_ms"] > s.latency_target_ms
            infeasible = perf_bad | (bounds["area_mm2"] > s.area_target_mm2)
            pruned &= infeasible
        return pruned

    def _dominated(self, canon: tuple) -> bool:
        """Weak dominance of a bound tuple by any refined incumbent (lock
        held). Weak (all-axes ≤) is what preserves the frontier: an equal-
        everywhere candidate is a duplicate the frontier rejects anyway."""
        for inc in self._incumbents:
            if all(p <= c for p, c in zip(inc, canon)):
                return True
        return False

    def _admit_incumbent(self, canon: tuple) -> None:
        """Insert an exact record's canon tuple, keeping the set
        nondominated (lock held)."""
        for inc in self._incumbents:
            if inc == canon or _dominates(inc, canon):
                return
        self._incumbents = [
            inc for inc in self._incumbents if not _dominates(canon, inc)
        ]
        self._incumbents.append(canon)

    # ---- protocol ---------------------------------------------------------

    def estimate_batch(
        self,
        specs: Sequence,
        hs: Sequence,
        batch: int = 1,
        vecs=None,
        accs=None,
    ) -> HwMetrics:
        n = len(specs)
        tr = obs_trace.active()
        t0 = tr.now() if tr is not None else 0.0
        bounds = simulator.lower_bounds(list(specs), list(hs), batch=batch)
        records: list = [None] * n
        static = bounds["invalid"]
        env = self._envelope_pruned(bounds) & ~static
        with self._lock:  # stats and incumbents are shared across searches
            self.stats.batches += 1
            self.stats.requested += n
            self.stats.static_invalid += int(static.sum())
            self.stats.envelope_pruned += int(env.sum())

        survivors = [i for i in range(n) if not (static[i] or env[i])]
        acc_of = None
        if accs is not None:
            acc_of = accs if callable(accs) else accs.__getitem__
        if self.prune_dominated and acc_of is not None and survivors:
            with self._lock:
                keep = []
                for i in survivors:
                    bound = {
                        "accuracy": float(acc_of(i)),
                        "latency_ms": float(bounds["latency_ms"][i]),
                        "energy_mj": float(bounds["energy_mj"][i]),
                        "area_mm2": float(bounds["area_mm2"][i]),
                    }
                    if self._dominated(_canon(bound, DEFAULT_OBJECTIVES)):
                        self.stats.dominance_pruned += 1
                    else:
                        keep.append(i)
                survivors = keep

        if tr is not None:
            # the prefilter span covers bounds + envelope + dominance —
            # everything the cascade does before paying for full simulation
            tr.complete(
                "cascade_prefilter", t0,
                {"n": n, "survivors": len(survivors)},
            )
        if survivors:
            with self._lock:
                self.stats.refined += len(survivors)
            sub_vecs = None if vecs is None else [vecs[i] for i in survivors]
            sub_accs = None
            if acc_of is not None:
                sub_accs = [acc_of(i) for i in survivors]
            with obs_trace.span("cascade_refine", n=len(survivors)):
                hm = self.refine.estimate_batch(
                    [specs[i] for i in survivors],
                    [hs[i] for i in survivors],
                    batch=batch,
                    vecs=sub_vecs,
                    accs=sub_accs,
                )
            with self._lock:
                for j, (i, rec) in enumerate(zip(survivors, hm.records)):
                    records[i] = rec
                    if rec is None:
                        self.stats.refine_invalid += 1
                    elif self.prune_dominated and sub_accs is not None:
                        exact = {
                            "accuracy": float(sub_accs[j]),
                            "latency_ms": rec["latency_ms"],
                            "energy_mj": rec["energy_mj"],
                            "area_mm2": rec["area_mm2"],
                        }
                        self._admit_incumbent(_canon(exact, DEFAULT_OBJECTIVES))
        return HwMetrics(records=records, fidelity=self.fidelity)
