"""DurableRecordStore — the engine's raw-metric memo, persisted.

The paper's multi-use-case result (Sec. 4.5) rests on amortizing candidate
evaluations across many searches; `engine.RecordStore` (PR 2) does that only
within one process lifetime. `DurableRecordStore` extends it with an
append-only JSONL log so the memo survives crashes, preemptions and new
sessions:

* **append-only**: every `put` appends one JSON line
  ``{"k": <hex key>, "w": <writer label>, "r": <raw record>}`` and flushes,
  so a hard kill loses at most the line being written;
* **crash-safe load**: rehydration parses the log line by line, skips a
  torn/corrupt trailing line (counted in ``loaded_dropped``), and applies
  last-write-wins per key — a fresh process starts at the prior hit rate;
* **content-addressed + namespace-aware**: keys are the engine's
  ``sha1(namespace) ++ vec.tobytes()`` (see ``engine.split_key``); engine
  namespaces are content-based where possible (``engine._identity_token``),
  which is what makes cross-*process* hits sound;
* **compaction**: duplicates and FIFO-evicted entries accumulate in the log;
  ``compact()`` atomically rewrites it to exactly the live in-memory
  entries (write temp file, ``os.replace``, fsync the directory — the
  rename alone is not durable on POSIX: a crash between the rename and the
  directory sync can resurrect the pre-compact log).

**Log shipping** (the sharded-executor layout, ``repro_torch.runtime.executor``):
the single-writer discipline scales to multi-process sweeps by giving each
worker its own append-only *segment* next to the base log —
``store.jsonl.worker-<k>`` — via ``segment="<k>"``. A segment store appends
only to its own file but *loads* the base log plus every sibling segment, so
workers start warm on everything any prior run persisted. Readers (the base
store, the serve tier) merge base + segments last-write-wins in a
deterministic order (base first, then segments sorted by worker index);
since keys are content-addressed raw metrics, two writers can only ever
disagree on a key by writing identical bytes, so merge order never changes
values. ``refresh()`` folds in lines other writers appended since the last
read (per-file byte offsets; a live writer's in-flight torn tail is left for
the next refresh), and ``compact()`` on the base store merges and retires
the segments — the compacted log is exactly the single-file layout the
serve tier already reads. A directory path is accepted everywhere a
store path is (``<dir>/store.jsonl``).

Thread-safe like its base class: N concurrent searches
(``repro_torch.runtime.executor``) can share one durable store.

Counterpart of ``repro/runtime/store.py``: a copy over the port's
``engine.RecordStore``. The line format is the reference's, but the port's
keys carry the port's namespace digest (``engine.IMPL``), so the two
implementations' logs agree record for record by decision vector
(``engine.split_key(key)[1]``), never by key.
"""

from __future__ import annotations

import json
import os
import tempfile
from pathlib import Path
from typing import Optional, Union

from repro_torch.core.engine import RecordStore
from repro_torch.obs import trace as obs_trace

_SEGMENT_INFIX = ".worker-"


def _dump_line(key: bytes, raw: dict, writer: Optional[str]) -> str:
    return json.dumps({"k": key.hex(), "w": writer, "r": raw}, separators=(",", ":"))


def _fsync_dir(path: Path) -> None:
    """fsync a directory so just-renamed/unlinked entries survive a crash
    (``os.replace`` makes the swap atomic but not durable: POSIX requires a
    sync on the *directory* to persist the new entry)."""
    fd = os.open(str(path), getattr(os, "O_DIRECTORY", os.O_RDONLY))
    try:
        os.fsync(fd)
    except OSError:  # pragma: no cover - e.g. filesystems without dir fsync
        pass
    finally:
        os.close(fd)


def _segment_sort_key(base_name: str, p: Path):
    """Deterministic segment merge order: numeric worker ids numerically
    (worker-2 before worker-10), then any non-numeric ids lexically."""
    suffix = p.name[len(base_name) + len(_SEGMENT_INFIX):]
    return (0, int(suffix), "") if suffix.isdigit() else (1, 0, suffix)


class DurableRecordStore(RecordStore):
    """A ``RecordStore`` backed by an append-only JSONL log (module doc).

    ``read_only=True`` opens the log strictly for reading: the store never
    acquires an append handle, and ``put``/``compact`` raise instead of
    mutating the file — so a reader (the serve tier) can
    rehydrate a *live* log without interfering with a concurrent writer
    (the load tolerates the writer's in-flight torn tail the same way a
    crash-recovery load does).

    ``segment="<k>"`` makes this store the single writer of
    ``<path>.worker-<k>`` (log shipping, module doc): appends go only to the
    segment, loads merge base + all segments."""

    def __init__(
        self,
        path: Union[str, Path],
        max_entries: int = 1_000_000,
        fsync: bool = False,
        read_only: bool = False,
        segment: Optional[Union[str, int]] = None,
    ):
        super().__init__(max_entries)
        path = Path(path)
        if path.is_dir():
            path = path / "store.jsonl"
        self.path = path
        self.fsync = fsync
        self.read_only = read_only
        self.segment = None if segment is None else str(segment)
        self.loaded = 0          # entries rehydrated from the log(s) on open
        self.loaded_dropped = 0  # corrupt / torn lines skipped
        # of loaded_dropped: corrupt *interior* lines (valid records follow
        # them) — distinguishes bit rot / torn mid-log writes from the
        # benign torn tail a killed writer leaves
        self.corrupt_interior = 0
        self.shipped = 0         # entries folded in by refresh() after load
        self.appended = 0        # lines this process appended
        self._file = None
        self._offsets: dict[Path, int] = {}  # log-shipping read positions
        self._load()

    # ---- layout -----------------------------------------------------------

    @property
    def write_path(self) -> Path:
        """Where this store's appends land: the base log, or this writer's
        own segment."""
        if self.segment is None:
            return self.path
        return self.path.with_name(f"{self.path.name}{_SEGMENT_INFIX}{self.segment}")

    def segment_paths(self) -> list[Path]:
        """Sibling worker segments, in deterministic merge order."""
        if not self.path.parent.exists():
            return []
        return sorted(
            self.path.parent.glob(f"{self.path.name}{_SEGMENT_INFIX}*"),
            key=lambda p: _segment_sort_key(self.path.name, p),
        )

    def _log_paths(self) -> list[Path]:
        return [self.path] + self.segment_paths()

    # ---- persistence ------------------------------------------------------

    def _load(self) -> None:
        """Rehydrate the in-memory memo from the base log + every segment
        (last write wins, deterministic merge order — module doc)."""
        with self._lock:
            for p in self._log_paths():
                self.loaded += self._consume(p, count_torn_tail=True)

    def _consume(self, path: Path, count_torn_tail: bool) -> int:
        """Apply the complete lines appended to ``path`` since the last read;
        returns the number of *fresh* keys inserted. A trailing line without
        a newline is a torn append: on load (``count_torn_tail=True``) it is
        a dead writer's last write — count it dropped and move past it; on
        refresh it may be a live writer's in-flight append — leave the offset
        before it so the next refresh picks it up once complete."""
        off = self._offsets.get(path, 0)
        try:
            with open(path, "rb") as f:
                if off:
                    f.seek(off)
                data = f.read()
        except FileNotFoundError:
            return 0
        fresh = 0
        pos = 0
        while True:
            nl = data.find(b"\n", pos)
            if nl < 0:
                break
            line = data[pos:nl].strip()
            pos = nl + 1
            if not line:
                continue
            try:
                ent = json.loads(line)
                key = bytes.fromhex(ent["k"])
                raw, writer = ent["r"], ent.get("w")
            except (ValueError, KeyError, TypeError):
                # torn/corrupt interior line (or stray bytes): skip, keep
                # everything that parsed — corruption must never truncate
                # the valid tail behind it
                self.loaded_dropped += 1
                self.corrupt_interior += 1
                continue
            if key not in self._data:
                fresh += 1
            self._insert(key, raw, writer)
        tail = data[pos:]
        if tail.strip():
            if count_torn_tail:
                self.loaded_dropped += 1
                pos = len(data)
        else:
            pos = len(data)
        self._offsets[path] = off + pos
        return fresh

    def refresh(self) -> int:
        """Log shipping: fold in whatever other writers appended to the base
        log or any segment since the last load/refresh. Returns the number of
        fresh entries applied (also accumulated in ``shipped``). Safe against
        a live writer: only complete newline-terminated lines are consumed."""
        with obs_trace.span("store_refresh") as sp, self._lock:
            applied = 0
            for p in self._log_paths():
                applied += self._consume(p, count_torn_tail=False)
            self.shipped += applied
            sp.set(applied=applied)
            return applied

    def _handle(self):
        if self.read_only:
            raise RuntimeError(
                f"store opened read_only ({self.path}): appends are disabled"
            )
        if self._file is None:
            self.write_path.parent.mkdir(parents=True, exist_ok=True)
            self._file = open(self.write_path, "a", encoding="utf-8")
        return self._file

    def _append(self, key: bytes, raw: dict, writer: Optional[str]) -> None:
        f = self._handle()
        f.write(_dump_line(key, raw, writer) + "\n")
        f.flush()
        if self.fsync:
            os.fsync(f.fileno())
        self.appended += 1

    # ---- RecordStore interface -------------------------------------------

    def put(self, key: bytes, raw: dict, writer: Optional[str] = None) -> None:
        if self.read_only:
            raise RuntimeError(
                f"store opened read_only ({self.path}): appends are disabled"
            )
        with self._lock:
            super().put(key, raw, writer)
            self._append(key, raw, writer)

    def compact(self) -> int:
        """Atomically rewrite the base log to the live entries — merging and
        retiring any worker segments — then fsync the directory so neither
        the rename nor the segment unlinks can be undone by a crash. Returns
        the number of log lines dropped (stale duplicates + evicted keys +
        merged segment lines)."""
        with obs_trace.span("store_compact"), self._lock:
            if self.read_only:
                raise RuntimeError(
                    f"store opened read_only ({self.path}): compact is "
                    f"disabled (serve snapshots compact to a separate "
                    f"artifact instead)"
                )
            if self.segment is not None:
                raise RuntimeError(
                    f"segment writer ({self.write_path.name}): compact() runs "
                    f"on the base store, which merges and retires segments"
                )
            if self._file is not None:
                self._file.close()
                self._file = None
            # fold in anything other writers appended since the last read so
            # the rewrite is complete, then count what the merge retires
            for p in self._log_paths():
                self._consume(p, count_torn_tail=True)
            segments = self.segment_paths()
            before = 0
            for p in [self.path] + segments:
                try:
                    with open(p, "r", encoding="utf-8") as f:
                        before += sum(1 for ln in f if ln.strip())
                except FileNotFoundError:
                    pass
            fd, tmp = tempfile.mkstemp(
                prefix=self.path.name + ".",
                suffix=".compact",
                dir=str(self.path.parent),
            )
            try:
                with os.fdopen(fd, "w", encoding="utf-8") as f:
                    for key, (raw, writer) in self._data.items():
                        f.write(_dump_line(key, raw, writer) + "\n")
                    f.flush()
                    os.fsync(f.fileno())
                os.replace(tmp, self.path)
                _fsync_dir(self.path.parent)
            except BaseException:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
                raise
            for seg in segments:
                try:
                    os.unlink(seg)
                except FileNotFoundError:
                    pass
            if segments:
                _fsync_dir(self.path.parent)
            self._offsets = {self.path: self.path.stat().st_size}
            return before - len(self._data)

    def flush(self) -> None:
        with self._lock:
            if self._file is not None:
                self._file.flush()
                if self.fsync:
                    os.fsync(self._file.fileno())

    def close(self) -> None:
        with self._lock:
            if self._file is not None:
                self._file.close()
                self._file = None

    def __enter__(self) -> "DurableRecordStore":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
