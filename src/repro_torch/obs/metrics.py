"""Process-local metrics: counters, gauges, log-bucket histograms, one merge.

The repo's stats surfaces (``EngineStats``, ``StoreStats``, ``CascadeStats``,
``ServeStats``) each carry monotone counters plus derived ``*_rate``
properties. Before this module, every aggregation point re-implemented the
fold by hand (``session.nested`` summed numerics and recomputed one rate;
``executor._aggregate_stats`` did the same for store counters) — and each
copy had its own bugs (dropped non-numeric keys, summed rates). Two
primitives replace all of that:

* :func:`rate` — the single definition of a hit/prune/cache rate
  (``num / max(den, 1)``) used by every ``*_rate`` property in the repo;
* :func:`merge_stats` — fold N ``as_dict()`` outputs into one: counters sum,
  non-numeric keys pass through, and every known ``*_rate`` key is
  recomputed from the SUMMED counters (averaging per-shard rates would
  weight an idle shard the same as a busy one).

:class:`MetricsRegistry` is the process-local registry on top: named
counters/gauges/histograms for code that wants free-form metrics (the
tracer, benchmarks), plus weak registration of live stats objects so
``export()`` can snapshot everything observable in the process without any
surface pushing updates. Histograms use fixed log-spaced buckets, so p50/p90
/p99 come from counts alone — no sample storage, O(1) record cost.

Stdlib only; safe to import from any layer.
"""

from __future__ import annotations

import math
import threading
import weakref
from typing import Iterable, Mapping, Optional

__all__ = [
    "rate",
    "merge_stats",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "REGISTRY",
]


def rate(num: float, den: float) -> float:
    """THE rate definition: ``num / max(den, 1)`` (0 when nothing happened,
    never a ZeroDivisionError). Every ``*_rate`` surface routes through
    here so a rate means the same thing on every layer."""
    return num / max(den, 1)


#: How each known ``*_rate`` key is recomputed after counters are summed.
#: Each value is an ordered tuple of ``(numerator, denominator)`` counter-key
#: candidates — the first pair whose numerator key exists in the merged dict
#: wins. ``hit_rate`` needs two candidates because the store
#: (``hits/gets``) and the engine (``cache_hits/requested``) both expose a
#: key of that name over different counters.
RATE_SPECS: dict[str, tuple[tuple[str, str], ...]] = {
    "hit_rate": (("hits", "gets"), ("cache_hits", "requested")),
    "cross_hit_rate": (("cross_hits", "gets"),),
    "cache_hit_rate": (("cache_hits", "queries"),),
    "prune_rate": (("pruned", "requested"),),
}


def merge_stats(
    stats: Iterable[Mapping],
    defaults: Optional[Mapping[str, float]] = None,
) -> dict:
    """Fold N stats dicts (``as_dict()`` outputs) into one.

    * int/float/bool values sum (bools count occurrences);
    * ``*_rate`` keys are never summed — every key named in
      :data:`RATE_SPECS` whose counters are present is recomputed from the
      summed counters;
    * non-numeric values pass through: a single distinct value stays
      scalar, disagreeing values become the sorted list of distinct
      reprs (nothing is silently dropped);
    * ``defaults`` seeds counter keys (e.g. ``{"gets": 0}``) so the merged
      schema is stable even when the input list is empty.
    """
    total: dict = dict(defaults or {})
    passthrough: dict[str, list] = {}
    for s in stats:
        for key, v in s.items():
            if key in RATE_SPECS or key.endswith("_rate"):
                continue  # recomputed below, never summed
            if isinstance(v, bool) or isinstance(v, (int, float)):
                total[key] = total.get(key, 0) + v
            else:
                passthrough.setdefault(key, [])
                if v not in passthrough[key]:
                    passthrough[key].append(v)
    for key, vals in passthrough.items():
        total[key] = vals[0] if len(vals) == 1 else sorted(map(repr, vals))
    for key, candidates in RATE_SPECS.items():
        for num, den in candidates:
            if num in total:
                total[key] = rate(total[num], total.get(den, 0))
                break
    return total


# ---- primitives -----------------------------------------------------------


class Counter:
    """Monotone counter. ``inc`` is unsynchronized by design — CPython's
    GIL keeps the fast path cheap and per-event races only ever undercount
    telemetry, never corrupt it."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n


class Gauge:
    """Last-write-wins instantaneous value."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = v


class Histogram:
    """Fixed log-spaced buckets: quantiles from counts alone.

    Buckets span ``[10^LO_DECADE, 10^HI_DECADE)`` with ``PER_DECADE``
    buckets per decade (~16% relative resolution); values outside the span
    clamp into the edge buckets. ``record`` is two arithmetic ops and an
    array increment — no sample is ever stored, so a histogram's memory is
    constant no matter how many values it sees.
    """

    LO_DECADE = -7  # 100 ns, when recording seconds
    HI_DECADE = 5
    PER_DECADE = 16
    _N = (HI_DECADE - LO_DECADE) * PER_DECADE

    __slots__ = ("name", "counts", "count", "total", "min", "max")

    def __init__(self, name: str):
        self.name = name
        self.counts = [0] * self._N
        self.count = 0
        self.total = 0.0
        self.min = math.inf
        self.max = -math.inf

    def record(self, v: float) -> None:
        if v != v or v == math.inf:  # NaN/inf would poison the totals
            return
        self.count += 1
        self.total += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v
        if v <= 0.0:
            self.counts[0] += 1
            return
        i = int((math.log10(v) - self.LO_DECADE) * self.PER_DECADE)
        self.counts[min(max(i, 0), self._N - 1)] += 1

    def _bucket_upper(self, i: int) -> float:
        return 10.0 ** (self.LO_DECADE + (i + 1) / self.PER_DECADE)

    def quantile(self, q: float) -> float:
        """Upper edge of the bucket holding the q-quantile (exact min/max
        for q at the ends)."""
        if self.count == 0:
            return 0.0
        if q <= 0:
            return self.min
        if q >= 1:
            return self.max
        target = q * self.count
        seen = 0
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= target:
                return min(self._bucket_upper(i), self.max)
        return self.max

    def summary(self) -> dict:
        if self.count == 0:
            return {"count": 0}
        return {
            "count": self.count,
            "mean": self.total / self.count,
            "min": self.min,
            "p50": self.quantile(0.5),
            "p90": self.quantile(0.9),
            "p99": self.quantile(0.99),
            "max": self.max,
        }


# ---- registry -------------------------------------------------------------


class MetricsRegistry:
    """Process-local registry: named primitives + weakly-held stats objects.

    ``register(group, obj)`` holds a weakref to any object with
    ``as_dict()`` (the repo's stats dataclasses self-register on
    construction); transient engines/stores vanish from ``export()`` when
    they are garbage collected, so a long process running thousands of
    searches never leaks registry entries. ``export()`` snapshots
    everything: primitives by name, and each stats group folded through
    :func:`merge_stats`.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._histograms: dict[str, Histogram] = {}
        self._stats: dict[str, list] = {}  # group -> [weakref]

    def counter(self, name: str) -> Counter:
        with self._lock:
            c = self._counters.get(name)
            if c is None:
                c = self._counters[name] = Counter(name)
            return c

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            g = self._gauges.get(name)
            if g is None:
                g = self._gauges[name] = Gauge(name)
            return g

    def histogram(self, name: str) -> Histogram:
        with self._lock:
            h = self._histograms.get(name)
            if h is None:
                h = self._histograms[name] = Histogram(name)
            return h

    def register(self, group: str, obj) -> None:
        """Weakly register a live stats object (anything with ``as_dict``)
        under ``group``; dead refs are pruned opportunistically."""
        with self._lock:
            refs = self._stats.setdefault(group, [])
            refs.append(weakref.ref(obj))
            if len(refs) > 256:
                self._stats[group] = [r for r in refs if r() is not None]

    # merge_stats re-exported as a method so callers holding only a registry
    # (or the class) can fold dicts without a second import
    merge = staticmethod(merge_stats)

    def export(self) -> dict:
        """One dict of everything observable in this process right now."""
        with self._lock:
            out: dict = {
                "counters": {n: c.value for n, c in self._counters.items()},
                "gauges": {n: g.value for n, g in self._gauges.items()},
                "histograms": {n: h.summary() for n, h in self._histograms.items()},
                "stats": {},
            }
            for group, refs in self._stats.items():
                live = [r() for r in refs]
                live = [o for o in live if o is not None]
                self._stats[group] = [weakref.ref(o) for o in live]
                merged = merge_stats(o.as_dict() for o in live)
                merged["instances"] = len(live)
                out["stats"][group] = merged
        return out

    def reset(self) -> None:
        """Drop all primitives and registrations (tests/benchmarks)."""
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._histograms.clear()
            self._stats.clear()


#: The process-default registry the stats dataclasses register into.
REGISTRY = MetricsRegistry()
