"""Compacted frontier snapshots: the serve tier's on-disk artifact.

The durable store's JSONL log is optimized for *writers* (append-only,
crash-safe, one line per evaluation); the serve tier is read-dominated and
wants the opposite trade: a small, immutable, memory-mappable artifact
holding exactly the Pareto frontier — the only records a
best-config-for-scenario query can ever return. ``write_snapshot`` compacts
a frontier into one versioned columnar file; ``load_snapshot`` memory-maps
it back and rebuilds the ``ParetoFrontier`` without re-parsing a single
line of the source JSON log.

**File layout** (version 1)::

    <one JSON header line>\\n
    <raw little-endian column payload>

The header carries the format version, the row count, the frontier's
objectives/counters, per-column ``{dtype, shape, offset}`` descriptors
(offsets relative to the payload start, 8-byte aligned), the interned
namespace/writer string tables, and a ``sha256:`` content digest of the
payload — ``FrontierSnapshot.verify()`` (or ``load_snapshot(verify=True)``)
recomputes it, so a truncated or bit-flipped artifact is detected instead
of served.

**Columns.** The four objective metrics are plain float64 arrays
(``energy_mj`` uses NaN for ``None`` — predictor-backed records);
``utilization`` likewise NaN when absent; decision vectors are a ragged
int64 (data + offsets) pair; namespace digests and ``paid_by`` writer
labels are interned into header tables with int32 index columns; any
remaining record keys (search-history extras like ``reward`` or
``scenario``) round-trip through a ragged JSON sidecar that is empty — and
never parsed — for store-fed records. Reconstruction preserves the serve
record key order (``valid, accuracy, latency_ms, energy_mj, area_mm2,
[utilization], [predicted], <extras>, [vec], [ns], [paid_by]``), so
snapshot-served CLI answers are byte-identical to store-served ones.

Writes are atomic (temp file + ``os.replace``, the ``store.compact()``
pattern) and deterministic: the same frontier always produces the same
bytes, so snapshot artifacts diff cleanly and digests are comparable
across runs.

Counterpart of ``repro/serve/snapshot.py``: a copy over the port's
``DurableRecordStore``. ``MAGIC`` and ``VERSION`` are the reference's, and
the same frontier gives the same bytes in either implementation.
"""
from __future__ import annotations

import hashlib
import json
import math
import os
import tempfile
from pathlib import Path
from typing import Optional, Union

import numpy as np

from repro_torch.core.engine import split_key
from repro_torch.core.pareto import DEFAULT_OBJECTIVES, ParetoFrontier

MAGIC = "repro-frontier-snapshot"
VERSION = 1

# the serve record schema (see module doc); everything else rides the
# JSON extras sidecar
_METRIC_KEYS = (
    "valid",
    "accuracy",
    "latency_ms",
    "energy_mj",
    "area_mm2",
    "utilization",
    "predicted",
)
_SIDE_KEYS = ("vec", "ns", "paid_by")

# flags column bits
_F_PREDICTED = 1 << 0
_F_HAS_VEC = 1 << 1
_F_NO_ENERGY_KEY = 1 << 2  # record lacks the energy_mj key entirely


def _pad8(n: int) -> int:
    return (n + 7) & ~7


class _PayloadBuilder:
    """Accumulates aligned column buffers and their header descriptors."""

    def __init__(self):
        self.chunks: list[bytes] = []
        self.columns: dict[str, dict] = {}
        self.offset = 0

    def add(self, name: str, arr: np.ndarray) -> None:
        raw = np.ascontiguousarray(arr).tobytes()
        self.columns[name] = {
            "dtype": arr.dtype.str,
            "shape": list(arr.shape),
            "offset": self.offset,
            "nbytes": len(raw),
        }
        padded = _pad8(len(raw))
        self.chunks.append(raw + b"\x00" * (padded - len(raw)))
        self.offset += padded

    def payload(self) -> bytes:
        return b"".join(self.chunks)


def write_snapshot(
    frontier: ParetoFrontier,
    path: Union[str, Path],
    meta: Optional[dict] = None,
) -> dict:
    """Compact ``frontier`` into a columnar artifact at ``path`` (atomic).
    Returns the header dict (including the payload digest)."""
    path = Path(path)
    records = frontier.records()  # canonical order — row i = rank i
    n = len(records)

    acc = np.zeros(n)
    lat = np.zeros(n)
    energy = np.zeros(n)
    area = np.zeros(n)
    util = np.full(n, np.nan)
    flags = np.zeros(n, np.uint8)
    ns_table: dict[str, int] = {}
    writer_table: dict[str, int] = {}
    ns_idx = np.full(n, -1, np.int32)
    writer_idx = np.full(n, -1, np.int32)
    vec_offsets = np.zeros(n + 1, np.int64)
    vec_parts: list[np.ndarray] = []
    extras_offsets = np.zeros(n + 1, np.int64)
    extras_parts: list[bytes] = []

    for i, rec in enumerate(records):
        acc[i] = rec["accuracy"]
        lat[i] = rec["latency_ms"]
        area[i] = rec["area_mm2"]
        if "energy_mj" not in rec:
            flags[i] |= _F_NO_ENERGY_KEY
            energy[i] = np.nan
        else:
            e = rec["energy_mj"]
            energy[i] = np.nan if e is None else e
        u = rec.get("utilization")
        if u is not None:
            util[i] = u
        if rec.get("predicted"):
            flags[i] |= _F_PREDICTED
        vec = rec.get("vec")
        if vec is not None:
            flags[i] |= _F_HAS_VEC
            vec_parts.append(np.asarray(vec, np.int64))
        vec_offsets[i + 1] = vec_offsets[i] + (0 if vec is None else len(vec))
        ns = rec.get("ns")
        if ns is not None:
            ns_idx[i] = ns_table.setdefault(str(ns), len(ns_table))
        w = rec.get("paid_by")
        if w is not None:
            writer_idx[i] = writer_table.setdefault(str(w), len(writer_table))
        extras = {
            k: v
            for k, v in rec.items()
            if k not in _METRIC_KEYS and k not in _SIDE_KEYS
        }
        blob = b"" if not extras else json.dumps(
            extras, separators=(",", ":"), default=repr
        ).encode("utf-8")
        extras_parts.append(blob)
        extras_offsets[i + 1] = extras_offsets[i] + len(blob)

    b = _PayloadBuilder()
    b.add("accuracy", acc)
    b.add("latency_ms", lat)
    b.add("energy_mj", energy)
    b.add("area_mm2", area)
    b.add("utilization", util)
    b.add("vec_offsets", vec_offsets)
    b.add(
        "vec_data",
        np.concatenate(vec_parts) if vec_parts else np.zeros(0, np.int64),
    )
    b.add("extras_offsets", extras_offsets)
    b.add(
        "extras_data",
        np.frombuffer(b"".join(extras_parts), np.uint8)
        if extras_parts
        else np.zeros(0, np.uint8),
    )
    b.add("ns_idx", ns_idx)
    b.add("writer_idx", writer_idx)
    b.add("flags", flags)

    payload = b.payload()
    header = {
        "magic": MAGIC,
        "version": VERSION,
        "count": n,
        "digest": "sha256:" + hashlib.sha256(payload).hexdigest(),
        "objectives": [list(o) for o in frontier.objectives],
        "offered": frontier.offered,
        "admitted": frontier.admitted,
        "namespaces": [s for s, _ in sorted(ns_table.items(), key=lambda t: t[1])],
        "writers": [s for s, _ in sorted(writer_table.items(), key=lambda t: t[1])],
        "columns": b.columns,
        "meta": meta or {},
    }
    line = json.dumps(header, separators=(",", ":")).encode("utf-8") + b"\n"

    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(
        prefix=path.name + ".", suffix=".snap", dir=str(path.parent)
    )
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(line)
            f.write(payload)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    return header


class FrontierSnapshot:
    """A loaded snapshot: memory-mapped columns + record reconstruction.

    Columns are ``np.memmap`` views (read-only); nothing is copied until
    ``records()``/``frontier()`` materialize dicts. Row order is the
    frontier's canonical order, so rank ``i`` here is rank ``i`` in
    ``ParetoFrontier.records()``.
    """

    def __init__(self, path: Union[str, Path], header: dict, data_start: int):
        self.path = Path(path)
        self.header = header
        self.count = int(header["count"])
        self._data_start = data_start
        self._cols: dict[str, np.ndarray] = {}

    def column(self, name: str) -> np.ndarray:
        col = self._cols.get(name)
        if col is None:
            d = self.header["columns"][name]
            shape = tuple(d["shape"])
            if int(np.prod(shape)) == 0:
                col = np.empty(shape, dtype=np.dtype(d["dtype"]))
            else:
                col = np.memmap(
                    self.path,
                    dtype=np.dtype(d["dtype"]),
                    mode="r",
                    offset=self._data_start + d["offset"],
                    shape=shape,
                )
            self._cols[name] = col
        return col

    def verify(self) -> bool:
        """Recompute the payload digest against the header; raises on
        mismatch (truncation, bit rot, a hand-edited artifact)."""
        algo, _, want = self.header["digest"].partition(":")
        h = hashlib.new(algo)
        with open(self.path, "rb") as f:
            f.seek(self._data_start)
            for chunk in iter(lambda: f.read(1 << 20), b""):
                h.update(chunk)
        got = h.hexdigest()
        if got != want:
            raise ValueError(
                f"snapshot {self.path} payload digest mismatch: "
                f"header {want[:12]}…, payload {got[:12]}…"
            )
        return True

    def records(self) -> list[dict]:
        """Reconstruct the frontier records (serve key order, fresh dicts)."""
        n = self.count
        acc = self.column("accuracy")
        lat = self.column("latency_ms")
        energy = self.column("energy_mj")
        area = self.column("area_mm2")
        util = self.column("utilization")
        flags = self.column("flags")
        vec_off = self.column("vec_offsets")
        vec_data = self.column("vec_data")
        ex_off = self.column("extras_offsets")
        ex_data = self.column("extras_data")
        ns_idx = self.column("ns_idx")
        writer_idx = self.column("writer_idx")
        namespaces = self.header["namespaces"]
        writers = self.header["writers"]

        out: list[dict] = []
        for i in range(n):
            f = int(flags[i])
            rec: dict = {
                "valid": True,
                "accuracy": float(acc[i]),
                "latency_ms": float(lat[i]),
            }
            if not f & _F_NO_ENERGY_KEY:
                e = float(energy[i])
                rec["energy_mj"] = None if math.isnan(e) else e
            rec["area_mm2"] = float(area[i])
            u = float(util[i])
            if not math.isnan(u):
                rec["utilization"] = u
            if f & _F_PREDICTED:
                rec["predicted"] = True
            lo, hi = int(ex_off[i]), int(ex_off[i + 1])
            if hi > lo:
                rec.update(json.loads(bytes(ex_data[lo:hi]).decode("utf-8")))
            if f & _F_HAS_VEC:
                lo, hi = int(vec_off[i]), int(vec_off[i + 1])
                rec["vec"] = tuple(int(x) for x in vec_data[lo:hi])
            if ns_idx[i] >= 0:
                rec["ns"] = namespaces[int(ns_idx[i])]
            if writer_idx[i] >= 0:
                rec["paid_by"] = writers[int(writer_idx[i])]
            out.append(rec)
        return out

    def frontier(self) -> ParetoFrontier:
        """Reinstate the ``ParetoFrontier`` verbatim (members are mutually
        non-dominated by construction — no re-filtering, no JSON log
        parsing)."""
        return ParetoFrontier.from_state(
            {
                "objectives": self.header["objectives"],
                "records": self.records(),
                "offered": self.header["offered"],
                "admitted": self.header["admitted"],
            }
        )

    def __len__(self) -> int:
        return self.count


def load_snapshot(
    path: Union[str, Path], verify: bool = False
) -> FrontierSnapshot:
    """Memory-map a snapshot artifact. ``verify=True`` additionally checks
    the payload against the header digest before returning."""
    path = Path(path)
    with open(path, "rb") as f:
        line = f.readline()
        data_start = f.tell()
    header = json.loads(line.decode("utf-8"))
    if header.get("magic") != MAGIC:
        raise ValueError(f"{path} is not a {MAGIC} artifact")
    if header.get("version") != VERSION:
        raise ValueError(
            f"{path}: snapshot version {header.get('version')} "
            f"(this reader handles {VERSION})"
        )
    snap = FrontierSnapshot(path, header, data_start)
    if verify:
        snap.verify()
    return snap


# ---------------------------------------------------------------------------
# store log -> frontier (the fold the serve tier and the CLI share)
# ---------------------------------------------------------------------------


def load_store_frontier(
    store_path: Union[str, Path],
    objectives=DEFAULT_OBJECTIVES,
) -> tuple[ParetoFrontier, dict]:
    """Read-only store log → one frontier over every valid record, each
    annotated with its decision vector and namespace digest prefix (the
    config identity). Never touches the log for appends — safe against a
    concurrent writer (``DurableRecordStore(read_only=True)``).

    Sharded-run output needs no special handling: per-worker log segments
    (``<log>.worker-<k>``, see ``repro_torch.runtime.store``) merge into the load
    last-write-wins, and ``store_path`` may be the segment *directory*
    itself (resolved to its ``store.jsonl`` base log)."""
    from repro_torch.runtime import DurableRecordStore

    store = DurableRecordStore(store_path, read_only=True)
    frontier = ParetoFrontier(objectives)
    namespaces = set()
    total = 0
    for key, raw, writer in store.entries():
        total += 1
        ns, vec = split_key(key)
        namespaces.add(ns.hex()[:12])
        rec = dict(raw)
        rec["vec"] = vec
        rec["ns"] = ns.hex()[:12]
        if writer is not None:
            rec["paid_by"] = writer
        frontier.add(rec)
    info = {
        "records": total,
        "frontier": len(frontier),
        "namespaces": sorted(namespaces),
        "dropped_lines": store.loaded_dropped,
    }
    segments = store.segment_paths()
    if segments:  # only when sharded, so legacy snapshot bytes are unchanged
        info["segments"] = len(segments)
    return frontier, info


def snapshot_store(
    store_path: Union[str, Path],
    out_path: Union[str, Path],
    objectives=DEFAULT_OBJECTIVES,
) -> tuple[dict, dict]:
    """Compact a store's JSONL log into a frontier snapshot artifact:
    the serve tier's build step. ``store_path`` may also be a sharded run's
    store directory or base log — live worker segments are folded in
    (last-write-wins) without being modified. Returns
    ``(header, load info)``."""
    frontier, info = load_store_frontier(store_path, objectives)
    header = write_snapshot(
        frontier,
        out_path,
        meta={"source": str(store_path), **info},
    )
    return header, info
