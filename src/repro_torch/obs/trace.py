"""Chrome-trace-format span recording, off by default, segment-sharded.

One :class:`Tracer` per process writes complete ("ph": "X") events as JSONL
— one JSON object per line, the streaming flavor of the Chrome trace event
format — so a killed worker loses at most its buffered tail, exactly like
the durable store's append-only log. Multi-process runs follow the store's
segment pattern: the parent traces into ``<dir>/trace.jsonl``, each worker
into ``<dir>/trace.jsonl.worker-<k>`` (single writer per file, enablement
shipped via the ``REPRO_TRACE_DIR`` env var across spawn). :func:`merge`
folds every segment into one ``trace.json`` Chrome JSON-object file with a
per-file synthetic ``pid`` and a process_name metadata event, so Perfetto /
``chrome://tracing`` shows one labeled track per worker with the spawn and
steady-state phases visible side by side.

**Disabled cost is the design constraint.** :func:`span` reads one module
global; when no tracer is active it returns a shared no-op whose
``__enter__``/``__exit__`` are empty — a few tens of ns per call, cheap
enough to leave in every hot path permanently. Sub-µs paths (serve
``best()``) skip even that via the manual guard::

    tr = trace.active()
    t0 = tr.now() if tr is not None else 0.0
    ...work...
    if tr is not None:
        tr.complete("serve_best", t0, {...})

**Clock alignment.** Events are timestamped from ``time.monotonic_ns``
(immune to wall-clock steps); every segment starts with a meta line
anchoring its monotonic origin to the epoch (``time.time_ns``), and
:func:`merge` shifts each file onto the shared epoch axis, then rebases the
whole trace to start at ts=0. Cross-process skew is therefore bounded by
epoch-clock sampling jitter (µs-scale on one host), not by spawn ordering.

Tracing is observational only: nothing here touches RNG streams, store
bytes or checkpoint payloads. Stdlib only.
"""

from __future__ import annotations

import json
import os
import threading
import time
from pathlib import Path
from typing import Optional, Union

__all__ = [
    "Tracer",
    "TRACE_BASENAME",
    "TRACE_DIR_ENV",
    "span",
    "active",
    "start",
    "stop",
    "start_from_env",
    "trace_paths",
    "merge",
]

TRACE_BASENAME = "trace.jsonl"
#: env var a tracing parent sets before spawning workers (mirrors how
#: XLA_FLAGS crosses the spawn boundary in runtime.executor)
TRACE_DIR_ENV = "REPRO_TRACE_DIR"
_SEGMENT_INFIX = ".worker-"  # same layout as runtime.store segments

# one shared encoder: json.dumps(**kwargs) builds a fresh JSONEncoder per
# call, which is most of a span's record cost; encoding is also deferred to
# flush time so the hot path only appends the event dict to the buffer
_encode = json.JSONEncoder(separators=(",", ":"), default=str).encode


class Tracer:
    """Single-writer JSONL span recorder for one process.

    ``worker=k`` appends to the ``trace.jsonl.worker-<k>`` segment instead
    of the base file (log-shipping layout, module doc). Timestamps are µs
    since this tracer's monotonic origin; the leading clock meta line maps
    them onto the epoch for cross-file merging.
    """

    def __init__(
        self,
        path: Union[str, Path],
        worker: Optional[Union[int, str]] = None,
        label: Optional[str] = None,
        buffer: int = 256,
    ):
        path = Path(path)
        if path.suffix != ".jsonl":
            path = path / TRACE_BASENAME  # directory form, like the store
        self.dir = path.parent
        self.worker = None if worker is None else str(worker)
        if self.worker is not None:
            path = path.with_name(f"{path.name}{_SEGMENT_INFIX}{self.worker}")
        self.path = path
        self.label = label or (
            "main" if self.worker is None else f"worker-{self.worker}"
        )
        self.pid = os.getpid()
        self.events = 0
        self._buffer = max(int(buffer), 1)
        self._buf: list[dict] = []
        self._lock = threading.Lock()
        self._t0 = time.monotonic_ns()
        self.dir.mkdir(parents=True, exist_ok=True)
        self._file = open(self.path, "a", encoding="utf-8")
        # clock anchor: epoch µs at the monotonic origin (merge() uses this
        # to put every segment on one time axis)
        epoch_at_origin = (time.time_ns() - (time.monotonic_ns() - self._t0)) // 1000
        self._emit(
            {
                "meta": "clock",
                "label": self.label,
                "pid": self.pid,
                "epoch_us": epoch_at_origin,
            }
        )

    # -- time ---------------------------------------------------------------

    def now(self) -> float:
        """µs since this tracer's monotonic origin."""
        return (time.monotonic_ns() - self._t0) / 1000.0

    # -- recording ----------------------------------------------------------

    def _emit(self, obj: dict) -> None:
        # hot path: buffer the dict; serialization happens at flush
        with self._lock:
            self._buf.append(obj)
            if len(self._buf) >= self._buffer:
                self._flush_locked()

    def complete(self, name: str, start_us: float, args: Optional[dict] = None) -> None:
        """Record a complete ("X") event from ``start_us`` (a prior
        ``now()``) to now."""
        end = self.now()
        self.events += 1
        ev = {
            "name": name,
            "ph": "X",
            "ts": round(start_us, 3),
            "dur": round(max(end - start_us, 0.0), 3),
            "pid": self.pid,
            "tid": threading.get_native_id(),
        }
        if args:
            ev["args"] = args
        self._emit(ev)

    def complete_since_ns(
        self, name: str, start_monotonic_ns: int, args: Optional[dict] = None
    ) -> None:
        """Like :meth:`complete` for a start captured with
        ``time.monotonic_ns()`` before this tracer existed (worker spawn
        spans: the clock starts at worker-main entry, the tracer a few
        lines later)."""
        self.complete(name, (start_monotonic_ns - self._t0) / 1000.0, args)

    def instant(self, name: str, args: Optional[dict] = None) -> None:
        self.events += 1
        ev = {
            "name": name,
            "ph": "i",
            "ts": round(self.now(), 3),
            "s": "p",
            "pid": self.pid,
            "tid": threading.get_native_id(),
        }
        if args:
            ev["args"] = args
        self._emit(ev)

    # -- lifecycle ----------------------------------------------------------

    def _flush_locked(self) -> None:
        if self._buf and self._file is not None:
            self._file.write("\n".join(map(_encode, self._buf)) + "\n")
            self._file.flush()
            self._buf.clear()

    def flush(self) -> None:
        with self._lock:
            self._flush_locked()

    def close(self) -> None:
        with self._lock:
            self._flush_locked()
            if self._file is not None:
                self._file.close()
                self._file = None


# ---- module-level switch (THE hot-path guard) -----------------------------

_tracer: Optional[Tracer] = None


def active() -> Optional[Tracer]:
    """The process tracer, or None when tracing is off (the common case —
    callers on sub-µs paths branch on this instead of using span())."""
    return _tracer


def start(
    path: Union[str, Path],
    worker: Optional[Union[int, str]] = None,
    label: Optional[str] = None,
) -> Tracer:
    """Enable tracing for this process (replaces any active tracer)."""
    global _tracer
    if _tracer is not None:
        stop()
    _tracer = Tracer(path, worker=worker, label=label)
    return _tracer


def stop() -> Optional[Path]:
    """Flush, close and disable the process tracer; returns its path."""
    global _tracer
    tr, _tracer = _tracer, None
    if tr is None:
        return None
    tr.close()
    return tr.path


def start_from_env(
    worker: Optional[Union[int, str]] = None,
) -> Optional[Tracer]:
    """Worker-side enablement: start tracing iff the parent exported
    ``REPRO_TRACE_DIR`` before spawn; no-op (returns None) otherwise."""
    d = os.environ.get(TRACE_DIR_ENV)
    if not d:
        return None
    return start(d, worker=worker)


class _NoopSpan:
    """Shared do-nothing span — what span() returns when tracing is off."""

    __slots__ = ()

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **kw) -> "_NoopSpan":
        return self


_NOOP = _NoopSpan()


class _Span:
    __slots__ = ("_tr", "_name", "_args", "_t0")

    def __init__(self, tr: Tracer, name: str, args: dict):
        self._tr = tr
        self._name = name
        self._args = args

    def __enter__(self) -> "_Span":
        self._t0 = self._tr.now()
        return self

    def __exit__(self, *exc) -> bool:
        self._tr.complete(self._name, self._t0, self._args or None)
        return False

    def set(self, **kw) -> "_Span":
        """Attach/override event args from inside the span body."""
        self._args = {**self._args, **kw}
        return self


def span(name: str, **args):
    """``with span("simulate_batch", n=32): ...`` — records a complete
    event when a tracer is active, else returns the shared no-op. Exceptions
    propagate; the span still records (the failing interval is usually the
    interesting one)."""
    tr = _tracer
    if tr is None:
        return _NOOP
    return _Span(tr, name, args)


# ---- merge (segments -> one viewable trace) -------------------------------


def _segment_sort_key(base_name: str, p: Path):
    """Deterministic segment order, same rule as the durable store: numeric
    worker ids numerically, then non-numeric ids lexically."""
    suffix = p.name[len(base_name) + len(_SEGMENT_INFIX):]
    return (0, int(suffix), "") if suffix.isdigit() else (1, 0, suffix)


def trace_paths(trace_dir: Union[str, Path]) -> list[Path]:
    """Base trace file (if present) + worker segments in merge order."""
    d = Path(trace_dir)
    if d.suffix == ".jsonl":  # file form: treat its directory as the run dir
        d = d.parent
    base = d / TRACE_BASENAME
    out = [base] if base.exists() else []
    if d.exists():
        out += sorted(
            d.glob(f"{TRACE_BASENAME}{_SEGMENT_INFIX}*"),
            key=lambda p: _segment_sort_key(TRACE_BASENAME, p),
        )
    return out


def merge(trace_dir: Union[str, Path], out: Optional[Union[str, Path]] = None) -> Path:
    """Fold every trace segment in ``trace_dir`` into one Chrome-trace JSON
    object file (default ``<dir>/trace.json``) loadable in Perfetto /
    ``chrome://tracing``.

    Each source file becomes its own track: a synthetic ``pid`` (file index,
    stable merge order) plus ``process_name``/``process_sort_index``
    metadata events carrying the tracer's label. Timestamps are shifted
    onto the shared epoch axis via each file's clock meta line, then the
    whole trace is rebased to start at 0. Torn/corrupt lines (a killed
    worker's in-flight append) are skipped, same as the store's loader.
    """
    paths = trace_paths(trace_dir)
    if not paths:
        raise FileNotFoundError(f"no {TRACE_BASENAME}* files under {trace_dir}")
    events: list[dict] = []
    meta: list[dict] = []
    for fi, p in enumerate(paths):
        if _SEGMENT_INFIX in p.name:
            label = p.name[p.name.find(_SEGMENT_INFIX) + len(_SEGMENT_INFIX):]
        else:
            label = "main"
        anchor = 0.0  # epoch µs at this file's monotonic origin
        file_events: list[dict] = []
        with open(p, "r", encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    ev = json.loads(line)
                except ValueError:
                    continue  # torn tail of a killed writer
                if not isinstance(ev, dict):
                    continue
                if ev.get("meta") == "clock":
                    anchor = float(ev.get("epoch_us", 0.0))
                    label = ev.get("label", label)
                    continue
                if "ts" not in ev or "ph" not in ev:
                    continue
                ev["ts"] = float(ev["ts"]) + anchor
                ev["pid"] = fi
                file_events.append(ev)
        for tid in {ev.get("tid", 0) for ev in file_events}:
            meta.append(
                {
                    "name": "thread_name",
                    "ph": "M",
                    "pid": fi,
                    "tid": tid,
                    "args": {"name": f"{label}/t{tid}"},
                }
            )
        meta.append(
            {
                "name": "process_name",
                "ph": "M",
                "pid": fi,
                "tid": 0,
                "args": {"name": label},
            }
        )
        meta.append(
            {
                "name": "process_sort_index",
                "ph": "M",
                "pid": fi,
                "tid": 0,
                "args": {"sort_index": fi},
            }
        )
        events.extend(file_events)
    if events:
        t_min = min(ev["ts"] for ev in events)
        for ev in events:
            ev["ts"] = round(ev["ts"] - t_min, 3)
    events.sort(key=lambda ev: (ev["ts"], ev["pid"], ev.get("tid", 0)))
    out_path = Path(out) if out is not None else Path(trace_dir) / "trace.json"
    payload = {"traceEvents": meta + events, "displayTimeUnit": "ms"}
    with open(out_path, "w", encoding="utf-8") as f:
        json.dump(payload, f, separators=(",", ":"))
    return out_path
