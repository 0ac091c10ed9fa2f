"""Incremental Pareto-frontier tracking over evaluated (α, h) records.

The sweep's accumulator: every record any scenario's search evaluates is
offered to one global ``ParetoFrontier`` over (accuracy ↑, latency ↓,
energy ↓, area ↓). Because the Eq. 4-6 reward is monotone in each metric and
feasibility only tightens as costs fall, the frontier contains a best record
for *every* scenario (any monotone scalarization + constraint filtering):
``frontier.best(scenario)`` answers "what would this use case pick?" without
re-running a search — scenarios added after the fact get served from records
other scenarios paid for.

Records with a missing metric (``None`` — e.g. predictor-backed records have
no energy) are treated as worst-possible on that objective, so fully measured
records dominate them but they still participate on the metrics they do have.
"""
from __future__ import annotations

import json
import math
from typing import Iterable, Mapping, Optional, Sequence

Objective = tuple[str, str]  # (record key, "min" | "max")

DEFAULT_OBJECTIVES: tuple[Objective, ...] = (
    ("accuracy", "max"),
    ("latency_ms", "min"),
    ("energy_mj", "min"),
    ("area_mm2", "min"),
)


def _canon(record: Mapping, objectives: Sequence[Objective]) -> tuple:
    """Record → canonical cost tuple (smaller is better on every axis)."""
    vals = []
    for key, sense in objectives:
        v = record.get(key)
        if sense == "max":
            vals.append(math.inf if v is None else -float(v))
        else:
            vals.append(math.inf if v is None else float(v))
    return tuple(vals)


def _dominates(a: tuple, b: tuple) -> bool:
    """Canonical-tuple dominance: a no-worse everywhere, better somewhere."""
    return all(x <= y for x, y in zip(a, b)) and a != b


def _tie_key(record: Mapping) -> str:
    """Deterministic total order over metric-identical records (records whose
    canonical tuples are equal but whose payloads differ — e.g. two decision
    vectors decoding to the same architecture). The frontier keeps the
    smallest tie-key, so the surviving *set* is independent of insertion
    order — which is what makes ``merge`` commutative and idempotent."""
    return json.dumps(record, sort_keys=True, default=repr)


def dominates(
    a: Mapping,
    b: Mapping,
    objectives: Sequence[Objective] = DEFAULT_OBJECTIVES,
) -> bool:
    """True when record ``a`` Pareto-dominates record ``b``."""
    return _dominates(_canon(a, objectives), _canon(b, objectives))


class ParetoFrontier:
    """A mutually non-dominated set of records, maintained incrementally.

    ``add`` is O(frontier size) per record: a candidate dominated by a member
    is rejected; a metric-identical candidate replaces the member only when
    it wins the deterministic tie-break (``_tie_key``), so the surviving
    member *set* is insertion-order independent and ``merge`` is commutative
    and idempotent; otherwise it joins and evicts every member it dominates.
    Only valid records participate. Stored records are copied on the way in
    and handed out as copies, so callers may mutate freely.
    """

    def __init__(self, objectives: Sequence[Objective] = DEFAULT_OBJECTIVES):
        self.objectives = tuple(objectives)
        self._points: list[tuple[tuple, dict]] = []
        self.offered = 0   # records seen (valid or not)
        self.admitted = 0  # records that (at the time) joined the frontier

    def add(self, record: Mapping) -> bool:
        """Offer one record; returns True when it joins the frontier."""
        self.offered += 1
        if not record.get("valid", False):
            return False
        v = _canon(record, self.objectives)
        for i, (pv, pr) in enumerate(self._points):
            if pv == v:
                # metric-identical: keep the deterministic representative so
                # the frontier set is insertion-order-independent (see
                # _tie_key); the newcomer never counts as admitted
                if _tie_key(record) < _tie_key(pr):
                    self._points[i] = (v, dict(record))
                return False
            if _dominates(pv, v):
                return False
        keep = [t for t in self._points if not _dominates(v, t[0])]
        self._points = keep
        self._points.append((v, dict(record)))
        self.admitted += 1
        return True

    def add_many(self, records: Iterable[Mapping]) -> int:
        return sum(self.add(r) for r in records)

    def merge(self, other: "ParetoFrontier") -> int:
        return self.add_many(r for _, r in other._points)

    def records(self) -> list[dict]:
        """Frontier members, best-accuracy-first, as fresh dicts."""
        return [dict(r) for _, r in sorted(self._points, key=lambda t: t[0])]

    def state(self) -> dict:
        """Serializable snapshot (see ``repro_torch.runtime.checkpoint``)."""
        return {
            "objectives": [list(o) for o in self.objectives],
            "records": self.records(),
            "offered": self.offered,
            "admitted": self.admitted,
        }

    @classmethod
    def from_state(cls, state: Mapping) -> "ParetoFrontier":
        """Inverse of ``state``: members are reinstated verbatim (they are
        mutually non-dominated by construction, so no re-filtering)."""
        f = cls(tuple((k, s) for k, s in state["objectives"]))
        f._points = [(_canon(r, f.objectives), dict(r)) for r in state["records"]]
        f.offered = int(state["offered"])
        f.admitted = int(state["admitted"])
        return f

    def feasible(self, scenario) -> list[dict]:
        """Frontier members meeting ``scenario``'s hard constraints."""
        return [r for r in self.records() if scenario.feasible(r)]

    def best(self, scenario) -> Optional[dict]:
        """The frontier record ``scenario`` would select: argmax of the
        scenario's Eq. 4-6 score over its feasible members, falling back to
        all members when nothing is feasible (the soft-constraint regime —
        violations are penalized by the score itself). None when empty."""
        pool = self.feasible(scenario) or self.records()
        if not pool:
            return None
        return max(pool, key=scenario.score)

    def __len__(self) -> int:
        return len(self._points)

    def __iter__(self):
        return iter(self.records())
