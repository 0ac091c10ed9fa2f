"""Driver-agnostic checkpoint/resume for the search stack.

``Checkpointer`` is a tiny tagged blob store over one directory: each tag is
a single pickle file written atomically (temp file + ``os.replace``), so a
kill mid-save never corrupts the previous checkpoint. The search drivers
(``repro_torch.core.search._drive``) persist under a tag per search:

* controller state — policy logits, Adam moments, RNG bit-generator state,
  reward baselines (``controllers.*.state()``; numpy/python only, restored
  bitwise, which is what makes the resumed trajectory identical to an
  uninterrupted run). The snapshot carries the sampler's trajectory version
  (``controllers.TRAJECTORY_VERSION``); ``load_state`` refuses snapshots
  from a different sampler generation (e.g. pre-vectorization v1
  checkpoints), so a mid-search resume can never silently diverge across
  versions. A *completed* checkpoint replays without consulting controller
  state at all, so finished results from older generations stay servable;
* progress — samples done, accumulated history (every evaluated record),
  the best record/vector so far, wall-clock so far;
* identity metadata — space, controller, seed, sample budget, scenario —
  validated on resume so a tag can never silently resume a different search.

Composite drivers reuse the same mechanism per part: ``phase_search``
checkpoints ``<tag>.has`` / ``<tag>.nas``, ``nested_search``
``<tag>.outerN``, and ``SweepRunner`` ``sweep.<scenario>``. A *completed*
search's checkpoint doubles as its result cache: re-running the call replays
the finished ``SearchResult`` without evaluating anything — which is exactly
how resume skips finished phases/scenarios.

``result_state``/``result_from_state`` serialize a ``SearchResult`` (minus
the live ``Space`` object, which the caller re-supplies) for sweep- or
service-level snapshots; ``ParetoFrontier`` serializes itself
(``state()``/``from_state``, see ``repro_torch.core.pareto``).

Counterpart of ``repro/runtime/checkpoint.py``: a copy over the port's
``SearchResult``. The file format is the reference's, so each side's
``Checkpointer`` reads the other's files; what a driver does with them
differs: the port's ``search._drive`` writes ``meta["impl"] =
engine.IMPL`` into every search checkpoint and refuses to resume one whose
``impl`` differs or is missing (every checkpoint the reference writes), as
it refuses one from a different search.
"""
from __future__ import annotations

import hashlib
import os
import pickle
import re
import tempfile
from pathlib import Path
from typing import Optional, Union

import numpy as np

from repro_torch.core.search import SearchResult
from repro_torch.obs import trace as obs_trace

_TAG_RE = re.compile(r"[^A-Za-z0-9._-]")

# integrity footer appended after the pickle payload on save: magic + the
# payload's sha256 hexdigest + newline. pickle stops at its STOP opcode, so
# digest-less legacy files and footered files are both loadable; the footer
# makes corruption detectable instead of an unpickling crash.
_DIGEST_MAGIC = b"#repro-ckpt-sha256:"
_FOOTER_LEN = len(_DIGEST_MAGIC) + 64 + 1


def _tag_file(tag: str) -> str:
    """Filesystem-safe file name for a tag (collisions are fine to ignore:
    tags come from driver/scenario names, which are already distinct after
    this substitution)."""
    return _TAG_RE.sub("_", tag) + ".ckpt"


class Checkpointer:
    """Atomic tagged pickle blobs in one directory (see module doc).

    Every save appends a sha256 content digest (``_DIGEST_MAGIC`` footer)
    and every load verifies it: a corrupt checkpoint — bit rot, a torn copy,
    an injected fault — is treated as *missing* (``load`` returns ``None``,
    counted in ``corrupt``), so the search cold-restarts that scenario
    instead of dying in ``pickle.load``. ``digest=False`` skips writing
    footers (micro-benchmarks measuring the disabled path); verification
    still applies to any footered file it reads."""

    def __init__(self, root: Union[str, Path], digest: bool = True):
        self.root = Path(root)
        self.digest = digest
        self.saved = 0  # checkpoints written
        self.loaded = 0  # checkpoints read back intact
        self.corrupt = 0  # loads dropped: digest mismatch / unreadable pickle
        self.root.mkdir(parents=True, exist_ok=True)
        for stray in self.root.glob("*.tmp"):  # a kill mid-save leaves these
            try:
                stray.unlink()
            except OSError:
                pass

    def _path(self, tag: str) -> Path:
        return self.root / _tag_file(tag)

    def save(self, tag: str, state: dict) -> Path:
        path = self._path(tag)
        blob = pickle.dumps(state, protocol=pickle.HIGHEST_PROTOCOL)
        if self.digest:
            digest = hashlib.sha256(blob).hexdigest().encode("ascii")
            blob += _DIGEST_MAGIC + digest + b"\n"
        fd, tmp = tempfile.mkstemp(
            prefix=path.name + ".", suffix=".tmp", dir=str(self.root)
        )
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(blob)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        self.saved += 1
        return path

    def load(self, tag: str) -> Optional[dict]:
        path = self._path(tag)
        if not path.exists():
            return None
        data = path.read_bytes()
        payload = data
        if len(data) >= _FOOTER_LEN and data[-_FOOTER_LEN:].startswith(
            _DIGEST_MAGIC
        ):
            payload = data[:-_FOOTER_LEN]
            want = data[-65:-1]
            got = hashlib.sha256(payload).hexdigest().encode("ascii")
            if got != want:
                return self._drop_corrupt(tag, "sha256 mismatch")
        try:
            state = pickle.loads(payload)
        except Exception as e:  # noqa: BLE001 - any unreadable pickle
            return self._drop_corrupt(tag, f"{type(e).__name__}: {e}")
        self.loaded += 1
        return state

    def _drop_corrupt(self, tag: str, why: str) -> None:
        """Corrupt checkpoint == missing checkpoint: the caller falls back
        to a cold start of that search, which the deterministic trajectory
        makes result-identical — strictly better than crashing."""
        self.corrupt += 1
        tr = obs_trace.active()
        if tr is not None:
            tr.instant("checkpoint_corrupt", {"tag": tag, "why": why})
        return None

    def exists(self, tag: str) -> bool:
        return self._path(tag).exists()

    def delete(self, tag: str) -> bool:
        try:
            self._path(tag).unlink()
            return True
        except FileNotFoundError:
            return False

    def tags(self) -> list[str]:
        return sorted(p.stem for p in self.root.glob("*.ckpt"))

    def clear(self) -> int:
        n = 0
        for p in self.root.glob("*.ckpt"):
            p.unlink()
            n += 1
        return n


# ---------------------------------------------------------------------------
# result snapshots
# ---------------------------------------------------------------------------


def result_state(result: SearchResult) -> dict:
    """``SearchResult`` minus the live ``Space`` object (callers re-supply
    it on restore — spaces are code, not data)."""
    return {
        "best_vec": None if result.best_vec is None else np.asarray(result.best_vec),
        "best_record": result.best_record,
        "history": result.history,
        "space": result.space.name,
        "wall_s": result.wall_s,
        "engine_stats": result.engine_stats,
        "transferred_from": result.transferred_from,
    }


def result_from_state(state: dict, space) -> SearchResult:
    if space is not None and space.name != state["space"]:
        raise ValueError(
            f"result was produced over space {state['space']!r}, "
            f"got {space.name!r}"
        )
    return SearchResult(
        best_vec=None if state["best_vec"] is None else np.asarray(state["best_vec"]),
        best_record=state["best_record"],
        history=list(state["history"]),
        space=space,
        wall_s=state["wall_s"],
        engine_stats=state["engine_stats"],
        # .get: snapshots written before the transfer layer have no key
        transferred_from=state.get("transferred_from"),
    )
