"""Batched, cached candidate evaluation — the hub of the search stack.

Every search driver in ``repro_torch.core.search`` routes candidate evaluation
through an ``EvaluationEngine``: the controller emits a whole batch of integer
decision vectors, the engine decodes them, runs validity/latency/energy/area
through the vectorized simulator path (``simulator.simulate_batch``, one pass
of numpy over candidates × layers), scores them with the accuracy signal and
the paper's weighted-product reward (Eq. 4-6), and memoizes the finished
records in a content-addressed cache keyed on the encoded (α, h) vector —
repeated samples (common under PPO late in search) are free.

The per-batch loop is columnar end to end: store keys come from one
``tobytes`` pass over the batch (``_vec_keys``), accuracies from one
``acc_fn.batch`` call over the valid candidates, hardware columns from the
shared memoized ``simulator.hw_matrix``, and objective scoring from one
``score_batch`` pass — per-candidate dicts materialize only at the
store/record boundary, so the record format, cache keys, and store
namespace tokens are bit-for-bit those of the original per-candidate loop
(asserted by the engine tests; ``benchmarks/search_loop_bench.py`` measures
the loop).

Modes (inferred from the constructor arguments):
  * joint     — ``nas_space`` + ``has_space``: vec = [α ++ h]  (joint_search)
  * nas-only  — ``nas_space`` + ``fixed_h``:   vec = α         (fixed_hw_search)
  * has-only  — ``has_space`` + ``fixed_spec``/``fixed_acc``: vec = h
                (phase 1 of phase_search)

Backends (``repro_torch.hw`` — the unified ``CostBackend`` protocol):
  * ``AnalyticBackend`` (default) — the exact analytical simulator
    (``simulator.simulate_batch``);
  * ``LearnedBackend`` — the MLP cost model (paper Sec. 3.5.2's "cost model
    in the loop"), optionally with an energy head so energy-target
    scenarios run learned too; the legacy ``predictor=`` kwarg is a thin
    deprecation shim that wraps the object in a ``LearnedBackend``;
  * ``CascadeBackend`` — multi-fidelity: a vectorized lower-bound prefilter
    rejects infeasible-or-dominated candidates before the expensive
    backend runs.
Pass ``backend=`` to substitute any of them (or your own implementation of
the protocol). The engine validates the objective against
``backend.metrics`` — an energy-target ``RewardConfig`` needs a backend
that serves ``energy_mj``.

``CallableEngine`` wraps an arbitrary per-candidate evaluation function with
the same batch + cache interface (used by ``repro_torch.core.meshsearch``).

The memo holds *raw* metric records — validity, accuracy, latency, energy,
area — which are objective-independent; the reward and the feasibility bit are
recomputed from the raw record against the engine's current ``RewardConfig``
on every lookup (``score``). That split is what makes the cache reusable
across objectives: ``set_objective`` rebinds the reward without invalidating a
single entry, and a ``RecordStore`` passed as ``store=`` shares one memo
between many engines (the scenario sweep, ``repro_torch.core.sweep``, runs N
scenarios over one store and reports the cross-scenario hit rate).

See ``docs/architecture.md`` for the full picture and a worked example of
plugging in a custom cost backend.

Port note: a copy of ``repro/core/engine.py`` whose store namespaces carry
the implementation tag ``IMPL``, so the port's records never share a
``RecordStore`` namespace with the reference's (a port ``TrainedAccuracy``
with the reference's fields measures a different thing).
"""
from __future__ import annotations

import dataclasses
import hashlib
import threading
from typing import Callable, Optional, Sequence

import numpy as np

from repro_torch.core import simulator
from repro_torch.core.proxy import CachedAccuracy
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.hw.analytic import ANALYTIC, AnalyticBackend
from repro_torch.hw.learned import LearnedBackend
from repro_torch.core.reward import (
    RewardConfig,
    meets_constraints as meets_fn,
    reward_record,
)
from repro_torch.core.space import Space


#: implementation tag folded into every store namespace (module doc)
IMPL = "repro_torch"


@dataclasses.dataclass
class EngineStats:
    """Counters for one engine instance (all monotone)."""

    requested: int = 0    # candidates asked for (cache hits + evaluations)
    cache_hits: int = 0
    evaluated: int = 0    # candidates that reached a backend
    invalid: int = 0      # evaluated candidates the simulator rejected
    batches: int = 0      # evaluate_batch calls

    def __post_init__(self):
        obs_metrics.REGISTRY.register("engine", self)

    @property
    def hit_rate(self) -> float:
        return obs_metrics.rate(self.cache_hits, self.requested)

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["hit_rate"] = self.hit_rate
        return d


def _key(vec: np.ndarray) -> bytes:
    """Content address of an encoded decision vector."""
    return np.ascontiguousarray(vec, dtype=np.int64).tobytes()


# Store keys are ``sha1(namespace) ++ vec.tobytes()``: a fixed-length digest
# prefix followed by the encoded int64 decision vector. The runtime store
# persists keys verbatim; ``split_key`` recovers the two halves (the vec is
# what ``scripts/runtime_serve.py`` prints as the config identity).
NAMESPACE_BYTES = 20  # sha1 digest length


def split_key(key: bytes) -> tuple[bytes, tuple[int, ...]]:
    """Inverse of ``EvaluationEngine._vec_key``: (namespace digest, vec)."""
    ns, raw = key[:NAMESPACE_BYTES], key[NAMESPACE_BYTES:]
    return ns, tuple(int(x) for x in np.frombuffer(raw, dtype=np.int64))


def _identity_token(obj) -> object:
    """Stable identity of a namespace-relevant object (accuracy signal,
    cost backend). Content-based when possible — an object may publish a
    ``cache_key`` attribute/method (every ``repro_torch.hw`` backend does), and
    plain-scalar-field dataclasses (``SurrogateAccuracy``,
    ``TrainedAccuracy``) use their repr — so the namespace survives process
    restarts, which is what lets a ``repro_torch.runtime.DurableRecordStore``
    rehydrate at full hit rate. Falls back to ``id()`` for stateful objects
    (e.g. a ``LearnedBackend`` over a freshly trained CostModel): those
    namespaces are process-local, guarded against address reuse by
    ``RecordStore.pin``."""
    if obj is None:
        return None
    key = getattr(obj, "cache_key", None)
    if callable(key):
        key = key()
    if key is not None:
        return (IMPL, type(obj).__name__, str(key))
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        vals = list(vars(obj).values())
        if all(isinstance(v, (bool, int, float, str, tuple, frozenset,
                              type(None))) for v in vals):
            return (IMPL, type(obj).__name__, repr(obj))
    return (IMPL, type(obj).__name__, id(obj))


@dataclasses.dataclass
class StoreStats:
    """Counters for one RecordStore (all monotone)."""

    gets: int = 0        # lookups
    hits: int = 0
    cross_hits: int = 0  # hits whose writer label differs from the reader
    puts: int = 0
    evictions: int = 0   # FIFO evictions at the max_entries cap

    def __post_init__(self):
        obs_metrics.REGISTRY.register("store", self)

    @property
    def hit_rate(self) -> float:
        return obs_metrics.rate(self.hits, self.gets)

    @property
    def cross_hit_rate(self) -> float:
        return obs_metrics.rate(self.cross_hits, self.gets)

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["hit_rate"] = self.hit_rate
        d["cross_hit_rate"] = self.cross_hit_rate
        return d


class RecordStore:
    """A content-addressed (α, h) → raw-metric memo shared between engines.

    Entries are keyed on the engine-namespaced encoded vector and tagged with
    the label of the engine that wrote them, so ``stats.cross_hits`` counts
    lookups served by a record some *other* scenario (or search phase) paid
    for — the headline number of the scenario sweep. Raw records carry no
    reward: every reader re-scores them under its own objective, which is why
    sharing across objectives is sound.

    At the ``max_entries`` cap the oldest entry is evicted FIFO (dict
    insertion order) and counted in ``stats.evictions``. ``get``/``put`` are
    lock-protected, so N concurrent searches (``repro_torch.runtime.executor``) can
    share one store; ``repro_torch.runtime.DurableRecordStore`` adds an append-only
    on-disk log with the same interface.
    """

    def __init__(self, max_entries: int = 1_000_000):
        self.max_entries = max_entries
        self._data: dict[bytes, tuple[dict, Optional[str]]] = {}
        self.stats = StoreStats()
        self._pins: list = []
        self._lock = threading.RLock()
        # per-namespace gets/hits, only when the run is being traced (one
        # `is not None` check per get/put otherwise — observability must
        # cost ~nothing when off). Keys are namespace digest prefixes.
        self._ns_stats: Optional[dict[bytes, list[int]]] = (
            {} if obs_trace.active() is not None else None
        )

    def pin(self, *objs) -> None:
        """Keep strong references to the objects whose identity an engine's
        namespace hashes (accuracy signal, cost backend). Engines pin on
        construction so a store that outlives its engines can never serve a
        record under a recycled ``id()`` belonging to a different signal."""
        self._pins.extend(o for o in objs if o is not None)

    def get(self, key: bytes, reader: Optional[str] = None) -> Optional[dict]:
        with self._lock:
            self.stats.gets += 1
            ent = self._data.get(key)
            if self._ns_stats is not None:
                ns = self._ns_stats.setdefault(key[:NAMESPACE_BYTES], [0, 0])
                ns[0] += 1
                ns[1] += ent is not None
            if ent is None:
                return None
            raw, writer = ent
            self.stats.hits += 1
            if writer is not None and writer != reader:
                self.stats.cross_hits += 1
            return raw

    def put(self, key: bytes, raw: dict, writer: Optional[str] = None) -> None:
        with self._lock:
            self._insert(key, dict(raw), writer)
            self.stats.puts += 1

    def _insert(self, key: bytes, raw: dict, writer: Optional[str]) -> None:
        """Uncounted insert with FIFO eviction at the cap (lock held)."""
        if key not in self._data:
            while len(self._data) >= self.max_entries:
                self._data.pop(next(iter(self._data)))
                self.stats.evictions += 1
        self._data[key] = (raw, writer)

    def entries(self):
        """Snapshot of (key, raw record, writer label) triples."""
        with self._lock:
            return [(k, dict(raw), w) for k, (raw, w) in self._data.items()]

    def namespace_stats(self) -> dict[str, dict]:
        """Per-namespace ``{gets, hits, hit_rate}`` (hex digest keys) —
        populated only when the store was built under an active tracer;
        empty otherwise."""
        with self._lock:
            if not self._ns_stats:
                return {}
            return {
                ns.hex(): {
                    "gets": g,
                    "hits": h,
                    "hit_rate": obs_metrics.rate(h, g),
                }
                for ns, (g, h) in self._ns_stats.items()
            }

    def __len__(self) -> int:
        return len(self._data)


class EvaluationEngine:
    """Batched + memoized (α, h) → record evaluation (see module docstring)."""

    def __init__(
        self,
        nas_space: Optional[Space] = None,
        has_space: Optional[Space] = None,
        acc_fn: Optional[Callable] = None,
        rcfg: Optional[RewardConfig] = None,
        *,
        fixed_h=None,
        fixed_spec=None,
        fixed_acc: Optional[float] = None,
        constraint_mode: str = "full",  # "full" | "area_only" (phase-1 HAS)
        proxy_batch: int = 1,
        predictor=None,
        backend=None,
        cache: bool = True,
        max_cache_entries: int = 1_000_000,
        store: Optional[RecordStore] = None,
        label: Optional[str] = None,
    ):
        if rcfg is None:
            raise ValueError("EvaluationEngine needs a RewardConfig")
        if nas_space is not None and has_space is not None:
            self.mode = "joint"
        elif nas_space is not None:
            if fixed_h is None:
                raise ValueError("nas-only mode needs fixed_h")
            self.mode = "nas"
        elif has_space is not None:
            if fixed_spec is None or fixed_acc is None:
                raise ValueError("has-only mode needs fixed_spec and fixed_acc")
            self.mode = "has"
        else:
            raise ValueError("need at least one of nas_space / has_space")
        if self.mode != "has" and acc_fn is None:
            raise ValueError("joint / nas-only modes need an accuracy signal")
        if predictor is not None:
            # deprecation shim: predictor= is the pre-backend spelling of the
            # learned path; it becomes a LearnedBackend over the same object
            if backend is not None:
                raise ValueError("pass either backend= or the legacy "
                                 "predictor=, not both")
            if self.mode != "joint":
                raise ValueError("predictor backend requires joint mode "
                                 "(it is trained on joint (α, h) features)")
            backend = LearnedBackend(predictor, nas_space, has_space)
        self.backend = backend if backend is not None else ANALYTIC
        self.predictor = predictor  # legacy surface (None unless shimmed)
        if getattr(self.backend, "joint_only", False) and self.mode != "joint":
            raise ValueError(
                f"backend {self.backend.name!r} requires joint mode "
                f"(it featurizes joint (α, h) vectors); this engine is "
                f"{self.mode}-mode")
        self._require_metrics(rcfg)
        wants_acc = getattr(self.backend, "wants_accuracy", False)
        if (cache or store is not None or wants_acc) and acc_fn is not None \
                and not isinstance(acc_fn, CachedAccuracy):
            # collapses distinct vectors that alias to one architecture; the
            # signals are deterministic per spec, so records are unchanged
            acc_fn = CachedAccuracy(acc_fn)
        self.nas_space = nas_space
        self.has_space = has_space
        self.acc_fn = acc_fn
        self.rcfg = rcfg
        self.fixed_h = fixed_h
        self.fixed_spec = fixed_spec
        self.fixed_acc = fixed_acc
        self.constraint_mode = constraint_mode
        self.proxy_batch = proxy_batch
        self.max_cache_entries = max_cache_entries
        # one memo implementation for both flavors: a shared store passed in,
        # or a private RecordStore when plain cache=True
        if store is None and cache:
            store = RecordStore(max_cache_entries)
        self.store = store
        self.label = label
        if self.store is not None:
            # guard the id()-keyed namespace against address reuse: the store
            # must outlive every object whose identity it distinguishes
            acc = self.acc_fn
            self.store.pin(acc.fn if isinstance(acc, CachedAccuracy) else acc,
                           self.backend, getattr(self.backend, "model", None))
        self._ns = self._namespace()
        # short stable identity of the frozen architecture (has mode) —
        # drivers stamp it on history records so has-mode vecs from different
        # fixed specs stay distinguishable in a merged frontier
        self.fixed_spec_id: Optional[str] = None
        if fixed_spec is not None:
            self.fixed_spec_id = hashlib.sha1(
                repr(fixed_spec).encode()).hexdigest()[:12]
        self.stats = EngineStats()

    def _require_metrics(self, rcfg: RewardConfig) -> None:
        """An objective may only target metrics the backend certifies."""
        if rcfg.energy_target_mj is not None and \
                "energy_mj" not in self.backend.metrics:
            raise ValueError(
                f"backend {self.backend.name!r} serves {self.backend.metrics}"
                f" — an energy-target RewardConfig needs 'energy_mj' (train "
                f"the cost model with an energy head, or use the analytic "
                f"backend)"
            )

    def _backend_token(self):
        """The backend's namespace contribution. The stateless analytic
        backend maps to ``None`` — the pre-backend default — so stores
        written before the backend layer existed (and engines built without
        ``backend=``) keep resolving to the same namespaces. Exact type
        check: a *subclass* of AnalyticBackend may estimate differently and
        must not share the default namespace."""
        if type(self.backend) is AnalyticBackend:
            return None
        return _identity_token(self.backend)

    def _namespace(self) -> bytes:
        """Key prefix isolating this engine's raw records inside a shared
        ``RecordStore``: engines whose *metrics* could differ for the same
        encoded vector (mode, fixed config, inference batch, backend, accuracy
        signal) must not collide. Objective (rcfg/constraint_mode) is
        deliberately absent — raw records are objective-independent, and
        cross-objective reuse is the point of sharing a store. Identity of
        the accuracy signal / backend is content-based where possible
        (``_identity_token``; backends publish ``cache_key``) so the
        namespace — and therefore a durable store's hit rate — survives
        process restarts."""
        acc = self.acc_fn
        if isinstance(acc, CachedAccuracy):
            acc = acc.fn
        ident = repr((
            IMPL,
            self.mode,
            self.proxy_batch,
            self.fixed_h,
            repr(self.fixed_spec),
            self.fixed_acc,
            _identity_token(acc),
            self._backend_token(),
        ))
        return hashlib.sha1(ident.encode()).digest()

    # ---- public API -------------------------------------------------------

    def evaluate(self, vec: np.ndarray) -> dict:
        """Single-candidate convenience wrapper around ``evaluate_batch``."""
        return self.evaluate_batch(np.asarray(vec)[None, :])[0]

    def evaluate_batch(self, vecs: Sequence[np.ndarray]) -> list[dict]:
        """Evaluate a controller batch; returns one fresh record dict per vec
        (cached raw metrics are re-scored under the current objective on every
        lookup, so callers may mutate the returned records freely).

        The loop is columnar: store keys for the whole batch come from one
        ``tobytes`` pass, cache-missing candidates run through the backend
        and the batched accuracy signal as columns, and scoring happens once
        for the whole batch (``score_batch``); per-candidate dicts only
        materialize at the store/record boundary, so the record format and
        the content-addressed keys are unchanged from the per-candidate
        loop."""
        vecs = np.asarray(vecs)
        self.stats.batches += 1
        self.stats.requested += len(vecs)
        n = len(vecs)
        if n == 0:
            return []
        raws: list = [None] * n
        dup_of: dict[int, int] = {}
        missing: list[int] = []
        keys: Optional[list[bytes]] = None
        if self.store is None:
            missing = list(range(n))
        else:
            # duplicates WITHIN the batch also collapse: only the first
            # occurrence of a key is evaluated, the rest fan out below
            keys = self._vec_keys(vecs)
            pending: dict[bytes, int] = {}
            for i, k in enumerate(keys):
                raw = self._lookup(k)
                if raw is not None:
                    self.stats.cache_hits += 1
                    raws[i] = raw
                elif k in pending:
                    self.stats.cache_hits += 1
                    dup_of[i] = pending[k]
                else:
                    pending[k] = i
                    missing.append(i)
        if missing:
            # manual guard (not span()): this wraps the dominant cost of a
            # search step, and the tracer records the batch size per scenario
            tr = obs_trace.active()
            t0 = tr.now() if tr is not None else 0.0
            fresh = self._evaluate_candidates([vecs[i] for i in missing])
            if tr is not None:
                tr.complete(
                    "simulate_batch", t0,
                    {"n": len(missing), "label": self.label},
                )
            for i, raw in zip(missing, fresh):
                if keys is not None:
                    self._insert(keys[i], raw)
                raws[i] = raw
        for i, j in dup_of.items():
            raws[i] = raws[j]
        return self.score_batch(raws)

    def evaluate_looped(self, vecs: Sequence[np.ndarray]) -> list[dict]:
        """Reference implementation: the legacy per-candidate loop
        (``simulator.simulate_safe`` one candidate at a time, no caching).
        For simulator-backed engines ``evaluate_batch`` must match this
        bitwise — the engine tests and the engine micro-benchmark both
        enforce/report it. Non-exact backends (learned, cascade) have no
        looped equivalent (this raises)."""
        if not self.backend.exact:
            raise ValueError("evaluate_looped is the simulator reference "
                             f"path; this engine uses the non-exact "
                             f"{self.backend.name!r} backend")
        out = []
        for vec in np.asarray(vecs):
            spec, h = self._decode(vec)
            sim = simulator.simulate_safe(spec, h, batch=self.proxy_batch)
            out.append(self._record(sim, spec))
        return out

    def evaluate_decoded(self, specs: list, hs: list,
                         batched: bool = True) -> list[dict]:
        """Evaluation stage only: decoded (spec, h) candidates → records, with
        no vector decoding or memoization. ``batched=True`` runs the
        vectorized candidates × layers simulator pass; ``batched=False`` runs
        the legacy per-candidate loop. The engine micro-benchmark times this
        pair; both produce bitwise-identical records."""
        if batched:
            sims = simulator.simulate_batch(specs, hs, batch=self.proxy_batch)
        else:
            sims = [simulator.simulate_safe(s, h, batch=self.proxy_batch)
                    for s, h in zip(specs, hs)]
        return [self._record(sim, spec) for sim, spec in zip(sims, specs)]

    def cache_size(self) -> int:
        return 0 if self.store is None else len(self.store)

    def set_objective(
        self,
        rcfg: RewardConfig,
        constraint_mode: Optional[str] = None,
        label: Optional[str] = None,
    ) -> "EvaluationEngine":
        """Rebind the reward objective (and optionally the constraint mode and
        the store attribution label) without touching the memo: cached raw
        metrics re-score under the new objective on their next lookup, so
        switching scenarios never re-simulates. Returns self for chaining."""
        self._require_metrics(rcfg)
        self.rcfg = rcfg
        if constraint_mode is not None:
            self.constraint_mode = constraint_mode
        if label is not None:
            self.label = label
        return self

    def score(self, raw: dict) -> dict:
        """Raw metric record + current objective → finished record (always a
        fresh dict). The reward is Eq. 4-6 over the record's metrics and the
        feasibility bit honors ``constraint_mode`` — identical semantics to
        scoring at evaluation time, which is what makes cached raw records
        exact under objective changes."""
        if not raw.get("valid", False):
            return {
                "valid": False, "reward": self.rcfg.invalid_reward,
                "accuracy": 0.0, "latency_ms": None, "energy_mj": None,
                "area_mm2": None,
            }
        rec = dict(raw)
        rec["reward"] = float(reward_record(raw, self.rcfg))
        rec["meets_constraints"] = meets_fn(raw, self.rcfg,
                                            self.constraint_mode)
        return rec

    def score_batch(self, raws: Sequence[Optional[dict]]) -> list[dict]:
        """Columnar ``score`` over a batch: the metrics are pulled into
        struct-of-arrays columns once, the feasibility bits run as one numpy
        comparison pass, and fresh per-candidate dicts materialize only at
        the end. The Eq. 4-6 weighted product itself stays on the scalar
        path (``reward_record``) — numpy's SIMD ``pow`` can differ from
        libm's by one ulp, and ``score_batch`` must stay bitwise-identical
        to ``[self.score(r) for r in raws]`` (asserted by the engine
        tests)."""
        n = len(raws)
        if n == 0:
            return []
        rcfg = self.rcfg
        valid = np.zeros(n, bool)
        lat = np.ones(n)
        energy = np.ones(n)
        area = np.ones(n)
        has_energy = np.ones(n, bool)
        for i, raw in enumerate(raws):
            if raw is not None and raw.get("valid", False):
                valid[i] = True
                lat[i] = raw["latency_ms"]
                area[i] = raw["area_mm2"]
                e = raw.get("energy_mj")
                if e is None:
                    has_energy[i] = False
                else:
                    energy[i] = e
        if rcfg.energy_target_mj is not None:
            perf_ok = (energy <= rcfg.energy_target_mj) & has_energy
        else:
            perf_ok = lat <= rcfg.latency_target_ms
        area_ok = area <= rcfg.area_target_mm2
        if self.constraint_mode == "area_only":
            meets = area_ok
        else:
            meets = perf_ok & area_ok
        out: list = [None] * n
        for i, raw in enumerate(raws):
            if not valid[i]:
                out[i] = {
                    "valid": False, "reward": rcfg.invalid_reward,
                    "accuracy": 0.0, "latency_ms": None, "energy_mj": None,
                    "area_mm2": None,
                }
                continue
            rec = dict(raw)
            rec["reward"] = float(reward_record(raw, rcfg))
            rec["meets_constraints"] = bool(meets[i])
            out[i] = rec
        return out

    # ---- internals --------------------------------------------------------

    def _vec_key(self, vec: np.ndarray) -> bytes:
        return self._ns + _key(vec)

    def _vec_keys(self, vecs: np.ndarray) -> list[bytes]:
        """Store keys for a whole batch from ONE ``tobytes`` pass (row ``i``
        slices to exactly ``_vec_key(vecs[i])`` — same bytes, same keys)."""
        V = np.ascontiguousarray(vecs, dtype=np.int64)
        raw = V.tobytes()
        w = V.shape[1] * 8
        ns = self._ns
        return [ns + raw[i * w:(i + 1) * w] for i in range(V.shape[0])]

    def _lookup(self, k: bytes) -> Optional[dict]:
        return None if self.store is None else \
            self.store.get(k, reader=self.label)

    def _insert(self, k: bytes, raw: dict) -> None:
        if self.store is not None:
            self.store.put(k, raw, writer=self.label)

    def _decode(self, vec: np.ndarray):
        """vec -> (spec, h)."""
        if self.mode == "joint":
            na = self.nas_space.num_decisions
            return (self.nas_space.decode(vec[:na]),
                    self.has_space.decode(vec[na:]))
        if self.mode == "nas":
            return self.nas_space.decode(vec), self.fixed_h
        return self.fixed_spec, self.has_space.decode(vec)

    def _decode_batch(self, vecs: np.ndarray):
        """Batched ``_decode``: one column-wise option lookup per decision
        point (Space.decode_batch) instead of per (vector, decision)."""
        if self.mode == "joint":
            na = self.nas_space.num_decisions
            return (self.nas_space.decode_batch(vecs[:, :na]),
                    self.has_space.decode_batch(vecs[:, na:]))
        if self.mode == "nas":
            return self.nas_space.decode_batch(vecs), \
                [self.fixed_h] * len(vecs)
        return [self.fixed_spec] * len(vecs), \
            self.has_space.decode_batch(vecs)

    def _raw(self, sim: Optional[dict], spec, acc=None) -> dict:
        """One *raw* (objective-independent) metric record — the unit the
        cache/store memoizes. No reward, no feasibility: those are recomputed
        by ``score`` under whatever objective the engine holds at lookup
        time. ``acc`` carries a precomputed accuracy (the batched path scores
        the whole batch in one ``acc_fn.batch`` call). Pure — stats are
        counted by evaluate_batch/_evaluate_candidates only, so the reference
        paths (evaluate_looped/evaluate_decoded) don't skew the engine's
        counters."""
        if sim is None:
            return {"valid": False}
        if acc is None:
            acc = self.fixed_acc if self.mode == "has" else self.acc_fn(spec)
        energy = sim["energy_mj"]
        rec = {
            "valid": True, "accuracy": float(acc),
            "latency_ms": float(sim["latency_ms"]),
            "energy_mj": float(energy) if energy is not None else None,
            "area_mm2": float(sim["area_mm2"]),
        }
        if sim.get("utilization") is not None:
            rec["utilization"] = float(sim["utilization"])
        if sim.get("predicted"):
            rec["predicted"] = True
        return rec

    def _record(self, sim: Optional[dict], spec) -> dict:
        """Assemble one finished history record (shared by all evaluation
        paths, so batched/looped records differ only if the backend metrics
        differ)."""
        return self.score(self._raw(sim, spec))

    def _evaluate_candidates(self, vecs: list) -> list[dict]:
        """Backend pass over cache-missing candidates → raw records."""
        self.stats.evaluated += len(vecs)
        V = np.asarray(vecs)
        specs, hs = self._decode_batch(V)
        accs = None
        if getattr(self.backend, "wants_accuracy", False):
            # lazy per-index accessor: the cascade's dominance prefilter
            # needs accuracy only for candidates that survive its cheaper
            # stages, so the signal is evaluated on demand — and the engine
            # wraps acc_fn in CachedAccuracy whenever a backend wants
            # accuracy, so _raw re-reads stay free
            if self.mode == "has":
                accs = lambda i: float(self.fixed_acc)
            else:
                accs = lambda i: float(self.acc_fn(specs[i]))
        hm = self.backend.estimate_batch(
            specs, hs, batch=self.proxy_batch, vecs=V, accs=accs
        )
        sims = hm.records
        self.stats.invalid += sum(1 for s in sims if s is None)
        # columnar accuracy: ONE batch call over the specs that simulated
        # valid (invalid candidates never consume the accuracy signal —
        # same as the per-candidate path)
        acc_of: dict[int, float] = {}
        if self.mode != "has":
            live = [i for i, s in enumerate(sims) if s is not None]
            if live:
                # callable() matters: TrainedAccuracy carries an *int* field
                # named ``batch`` (its training batch size), not a batch API
                batch_fn = getattr(self.acc_fn, "batch", None)
                if callable(batch_fn):
                    vals = batch_fn([specs[i] for i in live])
                else:
                    vals = [self.acc_fn(specs[i]) for i in live]
                acc_of = dict(zip(live, vals))
        return [self._raw(sim, spec, acc=acc_of.get(i))
                for i, (sim, spec) in enumerate(zip(sims, specs))]


class CallableEngine:
    """The engine's batch + content-addressed-cache interface around an
    arbitrary per-candidate evaluation function ``eval_fn(vec) -> record``
    (record must carry a ``"reward"`` key). Used by the pod mesh search;
    useful whenever a search loop wants memoized evaluation without the
    (α, h) decoding machinery. Records are shallow-copied on cache hits —
    keep them flat, or re-copy nested mutables downstream."""

    def __init__(self, eval_fn: Callable[[np.ndarray], dict],
                 cache: bool = True, max_cache_entries: int = 1_000_000):
        self.eval_fn = eval_fn
        self.max_cache_entries = max_cache_entries
        self._cache: Optional[dict] = {} if cache else None
        self.stats = EngineStats()

    def evaluate_batch(self, vecs: Sequence[np.ndarray]) -> list[dict]:
        vecs = np.asarray(vecs)
        self.stats.batches += 1
        self.stats.requested += len(vecs)
        out = []
        for v in vecs:
            if self._cache is not None:
                hit = self._cache.get(_key(v))
                if hit is not None:
                    self.stats.cache_hits += 1
                    out.append(dict(hit))
                    continue
            rec = self.eval_fn(v)
            self.stats.evaluated += 1
            if not rec.get("valid", True):
                self.stats.invalid += 1
            if self._cache is not None:
                if len(self._cache) >= self.max_cache_entries:
                    self._cache.clear()
                self._cache[_key(v)] = dict(rec)
            out.append(rec)
        return out
