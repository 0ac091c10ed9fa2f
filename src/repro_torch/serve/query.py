"""Concurrent best-config-for-scenario queries over a live Pareto frontier.

The production query layer (paper observation 3: different use cases pick
very different optima, so traffic is millions of *queries*, not searches).
A ``FrontierServer`` holds one ``ParetoFrontier`` and answers
``best(scenario)`` exactly — bit-for-bit the record the brute-force
``ParetoFrontier.best`` would return — but in O(log² n) for the hot case
instead of O(n) score evaluations:

* **objective-sorted indexes** — records live in the frontier's canonical
  order (accuracy-descending); per performance axis (latency, energy) a
  sorted array locates the records meeting the target in one binary
  search, and a static merge tree (segment tree whose nodes hold
  area-sorted prefix-minimum canonical ranks) finds the *earliest
  canonical rank* that also meets the area target in O(log² n)
  comparisons. For a hard-constraint scenario the Eq. 4-6 score of every
  feasible record is exactly its accuracy (p=0 zeroes both penalty
  exponents), so that earliest rank IS the argmax — no floating-point
  scoring at all on the hot path, hence no vectorized-pow drift;

* **soft / infeasible fallback** — soft-mode scenarios and queries with an
  empty feasible set fall back to the exact scalar scorer
  (``scenario.score``) over the (index-filtered) candidate pool, keeping
  answers bitwise-equal to brute force in every regime;

* **LRU answer cache** — answers are memoized on the *canonicalized*
  scenario (targets + constraint mode, not the name) and the index
  version, so repeated production queries are O(1) dict hits;

* **thread-safe reads, copy-on-fold writes** — queries never take a lock:
  they read one immutable ``_Index`` reference. ``fold(records)`` (the
  admission path) adds records to the frontier, builds a fresh index, and
  swaps it atomically; in-flight queries keep answering from the index
  they started with — every answer is correct for a frontier state that
  existed at some fold boundary, which is exactly the serial-interleaving
  guarantee the serve property tests assert.

Counterpart of ``repro/serve/query.py``: a copy (numpy only).
"""
from __future__ import annotations

import dataclasses
import threading
from collections import OrderedDict
from typing import Iterable, Mapping, Optional, Sequence, Union

import numpy as np

from repro_torch.core.pareto import DEFAULT_OBJECTIVES, ParetoFrontier
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace

_MISS = object()


class _LRU:
    """A small thread-safe LRU with hit/miss counters."""

    def __init__(self, cap: int):
        self.cap = cap
        self.hits = 0
        self.misses = 0
        self._od: OrderedDict = OrderedDict()
        self._lock = threading.Lock()

    def get(self, key):
        with self._lock:
            if key in self._od:
                self._od.move_to_end(key)
                self.hits += 1
                return self._od[key]
            self.misses += 1
            return _MISS

    def put(self, key, value) -> None:
        with self._lock:
            self._od[key] = value
            self._od.move_to_end(key)
            while len(self._od) > self.cap:
                self._od.popitem(last=False)

    def __len__(self) -> int:
        return len(self._od)


class _MergeTree:
    """Static segment tree over perf-sorted rows for 2-constraint rank
    queries: ``first_rank(k, max_area)`` = the minimum canonical rank among
    the first ``k`` perf-sorted rows whose area ≤ ``max_area`` — O(log² n)
    (O(log n) nodes, one binary search each). Nodes hold their subtree's
    rows sorted by area plus the prefix-minimum of canonical ranks in that
    order. Build is O(n log n) once per fold."""

    def __init__(self, area: np.ndarray, rank: np.ndarray):
        n = len(area)
        size = 1
        while size < max(n, 1):
            size *= 2
        self.n = n
        self.size = size
        empty = (np.empty(0), np.empty(0, np.int64))
        self._nodes: list[tuple[np.ndarray, np.ndarray]] = [empty] * (2 * size)
        for i in range(n):
            self._nodes[size + i] = (area[i : i + 1], rank[i : i + 1].astype(np.int64))
        for v in range(size - 1, 0, -1):
            la, lr = self._nodes[2 * v]
            ra, rr = self._nodes[2 * v + 1]
            if len(la) == 0 and len(ra) == 0:
                continue
            a = np.concatenate([la, ra])
            r = np.concatenate([lr, rr])
            order = np.argsort(a, kind="stable")
            a = a[order]
            self._nodes[v] = (a, np.minimum.accumulate(r[order]))

    def first_rank(self, k: int, max_area: float) -> Optional[int]:
        best: Optional[int] = None
        lo, hi = self.size, self.size + min(k, self.n)
        while lo < hi:
            if lo & 1:
                best = self._visit(lo, max_area, best)
                lo += 1
            if hi & 1:
                hi -= 1
                best = self._visit(hi, max_area, best)
            lo >>= 1
            hi >>= 1
        return best

    def _visit(self, v: int, max_area: float, best: Optional[int]):
        areas, minrank = self._nodes[v]
        j = int(np.searchsorted(areas, max_area, side="right"))
        if j > 0:
            r = int(minrank[j - 1])
            if best is None or r < best:
                return r
        return best


class _Index:
    """One immutable view of the frontier: canonical-order records, metric
    columns, and per-perf-axis (sorted values, merge tree) indexes."""

    def __init__(self, frontier: ParetoFrontier, version: int):
        self.version = version
        self.records = frontier.records()  # canonical order, fresh dicts
        n = len(self.records)
        self.n = n
        self.lat = np.array([r["latency_ms"] for r in self.records], float)
        self.energy = np.array(
            [
                np.inf if r.get("energy_mj") is None else r["energy_mj"]
                for r in self.records
            ],
            float,
        )
        self.area = np.array([r["area_mm2"] for r in self.records], float)
        ranks = np.arange(n, dtype=np.int64)
        self.axes = {}
        for name, col in (("latency_ms", self.lat), ("energy_mj", self.energy)):
            order = np.argsort(col, kind="stable")
            self.axes[name] = (
                col[order],
                _MergeTree(self.area[order], ranks[order]),
            )

    def _targets(self, scenario) -> tuple[str, float, float]:
        rc = scenario.reward_config()
        if rc.energy_target_mj is not None:
            return "energy_mj", float(rc.energy_target_mj), rc.area_target_mm2
        return "latency_ms", float(rc.latency_target_ms), rc.area_target_mm2

    def first_feasible(self, axis: str, t_perf: float, t_area: float):
        """Earliest canonical rank meeting both constraints, or None."""
        vals, tree = self.axes[axis]
        k = int(np.searchsorted(vals, t_perf, side="right"))
        if k == 0:
            return None
        return tree.first_rank(k, t_area)

    def feasible_ranks(self, axis: str, t_perf: float, t_area: float):
        col = self.lat if axis == "latency_ms" else self.energy
        return np.nonzero((col <= t_perf) & (self.area <= t_area))[0]

    def best(self, scenario) -> Optional[dict]:
        """Exactly ``ParetoFrontier.best(scenario)`` (same record, same
        tie-breaks) via the index; see the module doc for why the hard-mode
        hot path needs no score evaluation at all."""
        if self.n == 0:
            return None
        axis, t_perf, t_area = self._targets(scenario)
        rank = self.first_feasible(axis, t_perf, t_area)
        if rank is None:
            # nothing feasible: brute-force the soft-constraint fallback
            # regime over the whole frontier (identical to ParetoFrontier)
            return max(self.records, key=scenario.score)
        if scenario.mode == "hard":
            # feasible hard-mode scores are exactly `accuracy`; canonical
            # order is accuracy-descending, so the earliest feasible rank
            # is the argmax with max()'s first-wins tie-break
            return self.records[rank]
        pool = [self.records[i] for i in self.feasible_ranks(axis, t_perf, t_area)]
        return max(pool, key=scenario.score)


def scenario_key(scenario) -> tuple:
    """Canonicalized cache identity of a scenario's *query semantics*: two
    scenarios with the same targets and mode share one answer regardless of
    their names."""
    return (
        scenario.mode,
        scenario.latency_target_ms,
        scenario.energy_target_mj,
        scenario.area_target_mm2,
    )


@dataclasses.dataclass
class ServeStats:
    """Counters for one server (all monotone)."""

    queries: int = 0
    cache_hits: int = 0
    index_answers: int = 0  # served via the O(log² n) rank index
    scan_answers: int = 0   # soft / infeasible fallback scans
    folds: int = 0
    folded_records: int = 0  # records offered through fold()
    evaluations: int = 0     # always 0: the serve tier never simulates

    def __post_init__(self):
        obs_metrics.REGISTRY.register("serve", self)

    @property
    def cache_hit_rate(self) -> float:
        return obs_metrics.rate(self.cache_hits, self.queries)

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["cache_hit_rate"] = self.cache_hit_rate
        return d


class FrontierServer:
    """Thread-safe query layer over one live ``ParetoFrontier`` (module doc).

    Readers (``best``/``answer``) are lock-free; ``fold`` serializes writers
    and swaps an immutable index, so queries and admissions interleave
    safely. Construct from an in-memory frontier, a snapshot artifact
    (``from_snapshot``) or a durable store log (``from_store``).
    """

    def __init__(
        self,
        frontier: Optional[ParetoFrontier] = None,
        objectives: Sequence = DEFAULT_OBJECTIVES,
        cache_size: int = 4096,
    ):
        if frontier is None:
            frontier = ParetoFrontier(objectives)
        self._frontier = frontier
        self._index = _Index(self._frontier, version=0)
        self._cache = _LRU(cache_size)
        self._fold_lock = threading.Lock()
        self.stats = ServeStats()

    # ---- constructors ------------------------------------------------------

    @classmethod
    def from_snapshot(cls, path, verify: bool = True, **kw) -> "FrontierServer":
        """Serve a compacted snapshot artifact (``repro_torch.serve.snapshot``).
        Verifies the payload digest by default — a serve tier should refuse
        a silently-corrupt artifact; pass ``verify=False`` to trust it."""
        from repro_torch.serve.snapshot import load_snapshot

        return cls(load_snapshot(path, verify=verify).frontier(), **kw)

    @classmethod
    def from_store(cls, path, **kw) -> "FrontierServer":
        """Serve a durable store's JSONL log (read-only fold; slower to
        open than a snapshot — that is what ``benchmarks/serve_bench.py``
        measures)."""
        from repro_torch.serve.snapshot import load_store_frontier

        frontier, _ = load_store_frontier(path)
        return cls(frontier, **kw)

    # ---- read path ---------------------------------------------------------

    @property
    def version(self) -> int:
        """Fold generation of the index currently serving reads."""
        return self._index.version

    def best(self, scenario) -> Optional[dict]:
        """The record ``scenario`` would select off the frontier — equal to
        ``ParetoFrontier.best(scenario)`` — as a fresh dict (callers may
        mutate). Cached per (index version, canonicalized scenario)."""
        # manual tracer guard, not span(): this path serves in ~a µs and the
        # context-manager wrapper would be a measurable fraction of it
        tr = obs_trace.active()
        if tr is None:
            return self._best(scenario)
        t0 = tr.now()
        rec = self._best(scenario)
        tr.complete("serve_best", t0, {"scenario": getattr(scenario, "name", None)})
        return rec

    def _best(self, scenario) -> Optional[dict]:
        self.stats.queries += 1
        idx = self._index  # one atomic read: a consistent view for the query
        key = (idx.version, scenario_key(scenario))
        hit = self._cache.get(key)
        if hit is not _MISS:
            self.stats.cache_hits += 1
            return None if hit is None else dict(hit)
        rec = idx.best(scenario)
        hot = rec is not None and scenario.mode == "hard" and scenario.feasible(rec)
        if hot:
            self.stats.index_answers += 1
        else:
            self.stats.scan_answers += 1
        self._cache.put(key, None if rec is None else dict(rec))
        return None if rec is None else dict(rec)

    def answer(self, scenario) -> dict:
        """The serve payload (CLI/JSON shape): scenario name, targets, best
        record, hard-feasibility of that record."""
        best = self.best(scenario)
        return {
            "scenario": scenario.name,
            "targets": scenario.describe(),
            "best": best,
            "feasible": best is not None and scenario.feasible(best),
        }

    def records(self) -> list[dict]:
        return [dict(r) for r in self._index.records]

    def __len__(self) -> int:
        return self._index.n

    # ---- write path --------------------------------------------------------

    def fold(self, records: Iterable[Mapping]) -> int:
        """Offer new records (an admission search's results, another store's
        frontier) to the live frontier; rebuilds and atomically swaps the
        read index. Returns the number of records that joined. Serialized
        across callers; readers are never blocked."""
        records = list(records)
        with obs_trace.span("snapshot_fold", n=len(records)) as sp:
            with self._fold_lock:
                added = self._frontier.add_many(records)
                self.stats.folds += 1
                self.stats.folded_records += len(records)
                if added:
                    self._index = _Index(
                        self._frontier, version=self._index.version + 1
                    )
            sp.set(added=added)
        return added

    def merge_frontier(self, other: ParetoFrontier) -> int:
        """``fold`` for a whole frontier (order-independent, idempotent —
        see ``ParetoFrontier.merge``)."""
        return self.fold(other.records())

    # ---- introspection -----------------------------------------------------

    def cache_info(self) -> dict:
        return {
            "size": len(self._cache),
            "cap": self._cache.cap,
            "hits": self._cache.hits,
            "misses": self._cache.misses,
        }


def brute_force_best(
    records: Iterable[Mapping], scenario, objectives=DEFAULT_OBJECTIVES
) -> Optional[dict]:
    """Reference implementation for the serve tests: fold ``records`` into a
    fresh frontier and take ``ParetoFrontier.best`` — the O(n)-per-query
    baseline ``FrontierServer.best`` must match bitwise."""
    f = ParetoFrontier(objectives)
    f.add_many(records)
    return f.best(scenario)
