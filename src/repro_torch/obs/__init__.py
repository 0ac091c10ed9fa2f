"""repro_torch.obs — unified telemetry: metrics registry, trace spans, run reports.

Three stdlib-only modules (no jax/numpy: importable from every layer without
cost, including spawned worker processes before jax initializes):

* ``metrics`` — process-local :class:`MetricsRegistry` of counters, gauges
  and fixed-log-bucket histograms (p50/p90/p99 without storing samples); the
  existing ``*Stats`` dataclasses register themselves into the default
  registry, and :func:`merge_stats` is THE way multiple stat dicts fold into
  one (sums counters, preserves non-numeric keys, recomputes every
  ``*_rate`` from the summed counters — never by averaging rates).
* ``trace`` — Chrome-trace-format span recording. Off by default:
  ``trace.span(...)`` returns a shared no-op when no tracer is active
  (nanoseconds per call), so instrumentation stays in the hot paths
  permanently. Multi-process runs follow the store's segment pattern
  (``trace.jsonl.worker-<k>``); :func:`trace.merge` produces one
  Perfetto/chrome://tracing-viewable file with per-worker tracks.
* ``report`` — merges a run's trace + metrics into a human-readable report
  (``scripts/obs_report.py``).

Tracing is purely observational: it never touches RNG streams, store keys,
record bytes or checkpoint payloads, so traced runs are bitwise-identical
to untraced ones.
"""

from repro_torch.obs import metrics, report, trace  # noqa: F401
from repro_torch.obs.metrics import REGISTRY, MetricsRegistry, merge_stats, rate  # noqa: F401
from repro_torch.obs.trace import span  # noqa: F401
