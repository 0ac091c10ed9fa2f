"""Run reports: merge a run's trace + metrics into numbers a human can read.

``scripts/obs_report.py <dir>`` is the reference's CLI face (a run of the port
writes the same trace and metrics files); this module does the work:

* :func:`validate_chrome_trace` — schema check for the merged trace file
  (required keys per event, non-negative durations, monotone ``ts`` — the
  invariants Perfetto/``chrome://tracing`` rely on). CI runs this against
  every smoke trace.
* :func:`build_report` — merge the segments (``trace.merge``), validate,
  and aggregate: top spans by cumulative wall time, per-worker utilization
  (interval-union busy time over track wall time, so nested spans don't
  double-count), per-scenario ``simulate_batch`` evaluation counts, and
  whatever ``metrics.json`` the run wrote (registry export + store
  namespace hit rates).
* :func:`render_report` — the human-readable text form.
* :func:`write_metrics` — the producer side: dump the default registry's
  ``export()`` (+ run-specific extras) to ``<dir>/metrics.json``.

Stdlib only. A copy of ``repro/obs/report.py``, reading the port's
``trace`` and ``metrics``.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional, Union

from repro_torch.obs import trace as trace_lib
from repro_torch.obs.metrics import REGISTRY

__all__ = [
    "validate_chrome_trace",
    "build_report",
    "render_report",
    "write_metrics",
    "METRICS_BASENAME",
]

METRICS_BASENAME = "metrics.json"

_REQUIRED_KEYS = ("name", "ph", "ts", "pid", "tid")


def validate_chrome_trace(path: Union[str, Path]) -> dict:
    """Validate a merged trace against the Chrome trace event schema.

    Checks: top-level ``traceEvents`` list, required keys on every event,
    numeric non-negative ``ts``/``dur``, and non-decreasing ``ts`` within
    each ``(pid, tid)`` track. Raises ``ValueError`` on the first
    violation; returns summary info (event/track/name counts) on success.
    """
    with open(path, "r", encoding="utf-8") as f:
        data = json.load(f)
    events = data.get("traceEvents")
    if not isinstance(events, list) or not events:
        raise ValueError(f"{path}: traceEvents missing or empty")
    last_ts: dict[tuple, float] = {}
    names: set[str] = set()
    spans = 0
    for i, ev in enumerate(events):
        if ev.get("ph") == "M":
            # metadata events carry no timeline position (no ts/dur)
            for key in ("name", "ph", "pid"):
                if key not in ev:
                    raise ValueError(f"{path}: event {i} missing {key!r}: {ev}")
            continue
        for key in _REQUIRED_KEYS:
            if key not in ev:
                raise ValueError(f"{path}: event {i} missing {key!r}: {ev}")
        ts = ev["ts"]
        if not isinstance(ts, (int, float)) or ts < 0:
            raise ValueError(f"{path}: event {i} bad ts {ts!r}")
        track = (ev["pid"], ev["tid"])
        if ts < last_ts.get(track, 0.0):
            raise ValueError(
                f"{path}: event {i} ts {ts} precedes {last_ts[track]} "
                f"on track {track} (merge must sort by ts)"
            )
        last_ts[track] = ts
        names.add(ev["name"])
        if ev["ph"] == "X":
            spans += 1
            dur = ev.get("dur", 0)
            if not isinstance(dur, (int, float)) or dur < 0:
                raise ValueError(f"{path}: event {i} bad dur {dur!r}")
    return {
        "events": len(events),
        "spans": spans,
        "tracks": len(last_ts),
        "names": sorted(names),
    }


def _busy_us(intervals: list[tuple[float, float]]) -> float:
    """Union length of (start, end) intervals — busy time that doesn't
    double-count nested or overlapping spans."""
    if not intervals:
        return 0.0
    intervals.sort()
    busy = 0.0
    cur_s, cur_e = intervals[0]
    for s, e in intervals[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return busy + (cur_e - cur_s)


def build_report(trace_dir: Union[str, Path], top: int = 12) -> dict:
    """Merge + validate the run's trace, then aggregate it (module doc)."""
    trace_dir = Path(trace_dir)
    merged = trace_lib.merge(trace_dir)
    info = validate_chrome_trace(merged)
    with open(merged, "r", encoding="utf-8") as f:
        events = json.load(f)["traceEvents"]

    proc_names: dict[int, str] = {}
    for ev in events:
        if ev.get("ph") == "M" and ev.get("name") == "process_name":
            proc_names[ev["pid"]] = ev["args"]["name"]

    spans: dict[str, dict] = {}
    workers: dict[int, dict] = {}
    scenarios: dict[str, dict] = {}
    # warm-vs-cold attribution for transfer sweeps: "search" spans carry the
    # scenario + transferred_from provenance, transfer_init/donor_load/
    # transfer_schedule are the warm-start overhead itself
    searches: dict[str, dict] = {}
    overhead = {"transfer_init_us": 0.0, "donor_load_us": 0.0,
                "schedule_us": 0.0}
    saw_transfer = False
    t_end = 0.0
    for ev in events:
        if ev.get("ph") != "X":
            continue
        name, ts, dur = ev["name"], ev["ts"], ev.get("dur", 0.0)
        t_end = max(t_end, ts + dur)
        agg = spans.setdefault(name, {"count": 0, "total_us": 0.0, "max_us": 0.0})
        agg["count"] += 1
        agg["total_us"] += dur
        agg["max_us"] = max(agg["max_us"], dur)
        w = workers.setdefault(
            ev["pid"],
            {
                "label": proc_names.get(ev["pid"], str(ev["pid"])),
                "events": 0,
                "intervals": [],
                "t0": ts,
            },
        )
        w["events"] += 1
        w["intervals"].append((ts, ts + dur))
        w["t0"] = min(w["t0"], ts)
        if name == "simulate_batch":
            args = ev.get("args", {})
            label = str(args.get("label") or "-")
            sc = scenarios.setdefault(label, {"batches": 0, "evaluations": 0})
            sc["batches"] += 1
            sc["evaluations"] += int(args.get("n", 0))
        elif name == "search":
            args = ev.get("args", {})
            label = str(args.get("scenario") or args.get("tag") or "-")
            s = searches.setdefault(
                label, {"search_us": 0.0, "samples": 0, "donor": None}
            )
            s["search_us"] += dur
            s["samples"] = max(s["samples"], int(args.get("samples", 0)))
            if args.get("transferred_from"):
                s["donor"] = str(args["transferred_from"])
                saw_transfer = True
        elif name == "transfer_init":
            overhead["transfer_init_us"] += dur
            saw_transfer = True
        elif name == "donor_load":
            overhead["donor_load_us"] += dur
            saw_transfer = True
        elif name == "transfer_schedule":
            overhead["schedule_us"] += dur
            saw_transfer = True

    for agg in spans.values():
        agg["mean_us"] = agg["total_us"] / max(agg["count"], 1)
    for w in workers.values():
        busy = _busy_us(w.pop("intervals"))
        wall = max(t_end - w.pop("t0"), 1e-9)
        w["busy_us"] = busy
        w["wall_us"] = wall
        w["utilization"] = min(busy / wall, 1.0)

    metrics = None
    mpath = trace_dir / METRICS_BASENAME
    if mpath.exists():
        with open(mpath, "r", encoding="utf-8") as f:
            metrics = json.load(f)

    transfer = None
    if saw_transfer:
        warm = {k: v for k, v in searches.items() if v["donor"]}
        cold = {k: v for k, v in searches.items() if not v["donor"]}
        transfer = {
            "warm": warm,
            "cold": cold,
            "warm_us": sum(v["search_us"] for v in warm.values()),
            "cold_us": sum(v["search_us"] for v in cold.values()),
            **overhead,
        }

    top_spans = sorted(
        spans.items(), key=lambda kv: kv[1]["total_us"], reverse=True
    )[:top]
    return {
        "trace": str(merged),
        "info": info,
        "wall_us": t_end,
        "spans": dict(top_spans),
        "workers": {str(k): v for k, v in sorted(workers.items())},
        "scenarios": scenarios,
        "transfer": transfer,
        "metrics": metrics,
    }


def _fmt_us(us: float) -> str:
    if us >= 1e6:
        return f"{us / 1e6:.2f}s"
    if us >= 1e3:
        return f"{us / 1e3:.1f}ms"
    return f"{us:.0f}us"


def render_report(rep: dict) -> str:
    """The human-readable run report."""
    out = [
        f"run report: {rep['trace']}",
        f"  events={rep['info']['events']} spans={rep['info']['spans']} "
        f"tracks={rep['info']['tracks']} wall={_fmt_us(rep['wall_us'])}",
        "",
        "top spans by cumulative wall time:",
    ]
    for name, a in rep["spans"].items():
        out.append(
            f"  {name:<22} count={a['count']:<6} total={_fmt_us(a['total_us']):<9} "
            f"mean={_fmt_us(a['mean_us']):<9} max={_fmt_us(a['max_us'])}"
        )
    if rep["workers"]:
        out += ["", "worker utilization (busy/wall within the traced span):"]
        for _pid, w in rep["workers"].items():
            out.append(
                f"  {w['label']:<14} events={w['events']:<6} "
                f"busy={_fmt_us(w['busy_us']):<9} util={w['utilization']:.0%}"
            )
    if rep["scenarios"]:
        out += ["", "per-scenario evaluations (simulate_batch spans):"]
        for label, sc in sorted(rep["scenarios"].items()):
            out.append(
                f"  {label:<18} evaluations={sc['evaluations']:<7} "
                f"batches={sc['batches']}"
            )
    transfer = rep.get("transfer")
    if transfer:
        out += [
            "",
            f"scenario transfer: {len(transfer['cold'])} cold "
            f"({_fmt_us(transfer['cold_us'])} search) / "
            f"{len(transfer['warm'])} warm "
            f"({_fmt_us(transfer['warm_us'])} search); overhead "
            f"schedule={_fmt_us(transfer['schedule_us'])} "
            f"donor_load={_fmt_us(transfer['donor_load_us'])} "
            f"init={_fmt_us(transfer['transfer_init_us'])}",
        ]
        for label, s in sorted(transfer["warm"].items()):
            out.append(
                f"  {label:<28} warm <- {s['donor']:<24} "
                f"search={_fmt_us(s['search_us']):<9} "
                f"samples={s['samples']}"
            )
        for label, s in sorted(transfer["cold"].items()):
            out.append(
                f"  {label:<28} cold{'':<31} "
                f"search={_fmt_us(s['search_us']):<9} "
                f"samples={s['samples']}"
            )
    metrics = rep.get("metrics")
    if metrics:
        ns = metrics.get("namespaces")
        if ns:
            out += ["", "store cache hit rate per namespace:"]
            for name, d in sorted(ns.items()):
                out.append(
                    f"  {name:<28} gets={d.get('gets', 0):<7} "
                    f"hit_rate={d.get('hit_rate', 0.0):.1%}"
                )
        stats = (metrics.get("registry") or {}).get("stats")
        if stats:
            out += ["", "stats groups (live objects at export):"]
            for group, d in sorted(stats.items()):
                keys = ", ".join(
                    f"{k}={d[k]}"
                    for k in sorted(d)
                    if isinstance(d[k], int) and k != "instances"
                )
                out.append(f"  {group:<10} {keys}")
    return "\n".join(out)


def write_metrics(trace_dir: Union[str, Path], extra: Optional[dict] = None) -> Path:
    """Producer side: dump the default registry export (+ run extras) next
    to the trace segments."""
    path = Path(trace_dir) / METRICS_BASENAME
    payload = {"registry": REGISTRY.export()}
    if extra:
        payload.update(extra)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(payload, f, indent=1, default=str)
    return path
