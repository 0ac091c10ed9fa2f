"""Concurrent multi-search execution over one shared record store.

``SearchExecutor`` runs N searches (typically one per deployment scenario)
under one ``SearchRuntime``, on either of two backends:

* **threads** (default): the engine's batched ``simulator.simulate_batch``
  path spends its time in numpy, and controller updates and proxy training
  in torch — both release the GIL — so concurrent searches overlap one
  search's controller update with another's evaluation pass against a
  single shared ``RecordStore`` / ``DurableRecordStore``;
* **processes** (``processes=True``): the sharded executor. Jobs are
  partitioned round-robin across ``max_workers`` spawned worker processes;
  each worker owns its full Python runtime (no GIL sharing, its own torch
  and CUDA context) and
  is the **single writer** of its own store segment
  (``store.jsonl.worker-<k>``, see ``repro_torch.runtime.store``) — no cross-
  process lock on the hot path. Results ship back as ``result_state``
  payloads over a pipe of the worker's own; the parent merges frontiers,
  aggregates worker store stats, and ``refresh()``-es its own store so the
  segments' records are immediately visible (log shipping).
  ``devices_per_worker=N`` gives worker ``k`` the cards ``k·N … k·N+N−1``
  of the parent's visible cards, wrapped around them, through
  ``CUDA_VISIBLE_DEVICES`` (``worker_cards``); without it every worker sees
  every card the parent sees (on one card they share it).

Per-scenario trajectories are bitwise-identical across serial, thread and
process execution: a search's trajectory depends only on its seed,
controller state and the (deterministic, content-addressed) record values —
sharing evaluations changes who *pays* for a record, never its bytes.

Scheduling is budgeted: a ``Budget`` grants evaluation tokens (samples)
and/or wall-clock until a deadline; ``SearchRuntime.admit`` is consulted by
every driver at each batch boundary, and a denial makes the driver
checkpoint (when a ``Checkpointer`` is attached) and raise
``SearchInterrupted``. In process mode the budget lives in shared memory and
the stop token is mirrored to a process event, so admission stays a single
global decision. ``SearchExecutor.stop()`` is the graceful stop: every
in-flight search checkpoints at its next batch boundary; a later run with
the same checkpoint directory resumes all of them, completed ones replaying
for free — including searches a killed or crashed worker left behind.

**Self-healing** (process mode): jobs are dispatched one at a time to their
round-robin slot; workers heartbeat between batches. When a worker dies
mid-job, the parent respawns the slot and re-dispatches the job — the fresh
attempt resumes from the dead worker's last checkpoint and warm store
segment, so retried work replays instead of re-simulating, and per-scenario
trajectories stay bitwise-identical to a fault-free run. A hung-but-alive
worker is detected by the per-job deadline (``job_deadline_s``) or the
heartbeat timeout, killed, and its job re-dispatched the same way. Retries
are capped (``max_job_retries``) with exponential backoff; a job that
exhausts them is *quarantined* (``JobOutcome.quarantined``) so one poison
job cannot wedge a grid sweep. ``report.recovery`` counts every healing
action. Deterministic fault injection to exercise all of this lives in
``repro_torch.runtime.faults`` (env ``REPRO_FAULTS``).

Counterpart of ``repro/runtime/executor.py``, with three changes:

* **No parent wait can outlive its worker.** The reference ships every
  worker's messages over one shared ``multiprocessing.Queue``. A worker
  killed (a ``crash`` fault's ``os._exit``, a deadline kill) while its
  queue feeder thread writes leaves a torn message in the shared pipe, and
  with it the queue's cross-process write lock held: the parent's next
  ``get`` blocks on the torn message, or every other worker's puts block
  on the lock, and the wave waits forever on workers that can no longer
  report. Here each worker incarnation reports over a ``Pipe`` of its own
  (``_Outbox``), so a death takes only its own pipe with it: the parent
  reads the complete messages, then end-of-file, and never blocks on it.
  The heartbeat timeout also covers a slot that has a job in flight but
  has not reported ``ready`` (a respawn stuck before its first message),
  and the shared budget's lock is taken with a timeout, so a lock orphaned
  by a killed worker fails the job instead of hanging its siblings.
* **Cards, not simulated devices**: ``devices_per_worker`` sets
  ``CUDA_VISIBLE_DEVICES`` per worker (above). CUDA cannot run in a forked
  child, so the ``spawn`` context stays.
* Nothing here builds a kernel: a caller whose jobs launch one builds it
  before the pool spawns (``sweep.SweepRunner.run_concurrent`` calls the
  accuracy signal's ``prepare``), so N workers do not start N ``nvcc``s.
"""

from __future__ import annotations

import contextlib
import dataclasses
import multiprocessing
import multiprocessing.connection as mp_connection
import os
import pickle
import threading
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Callable, Optional, Union

from repro_torch.core.engine import RecordStore
from repro_torch.core.pareto import DEFAULT_OBJECTIVES, ParetoFrontier
from repro_torch.core.search import SearchInterrupted, SearchResult

from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace

from repro_torch.runtime.checkpoint import Checkpointer, result_from_state, result_state

from repro_torch.runtime import faults as faults_lib
from repro_torch.runtime.store import _SEGMENT_INFIX, DurableRecordStore

# test/CI hook: "<worker_id>:<admits>" makes that worker hard-exit (os._exit,
# as a kill -9 would) after its Nth admission — a deterministic mid-search
# death for kill-one-worker recovery tests
SELFKILL_ENV = "REPRO_EXECUTOR_SELFKILL"

# the longest a worker waits for the shared budget's lock: an admission
# holds it for microseconds, so a lock still held after this was orphaned
# by a killed worker (module doc)
BUDGET_LOCK_TIMEOUT_S = 30.0


class StopToken:
    """A latching stop request shared by every search under one runtime."""

    def __init__(self):
        self._event = threading.Event()
        self.reason: Optional[str] = None
        self._mirrors: list = []  # process events to trip alongside (run())

    def set(self, reason: str = "stop requested") -> None:
        self.reason = reason
        self._event.set()
        for m in list(self._mirrors):
            m.set()

    def is_set(self) -> bool:
        return self._event.is_set()

    def mirror(self, event) -> None:
        """Trip ``event`` (e.g. a ``multiprocessing.Event``) whenever this
        token trips — how a parent's stop() reaches spawned workers."""
        self._mirrors.append(event)
        if self.is_set():
            event.set()

    def unmirror(self, event) -> None:
        try:
            self._mirrors.remove(event)
        except ValueError:
            pass


class Budget:
    """Token/deadline admission: ``admit(n)`` reserves ``n`` evaluation
    tokens if the sample budget allows and the deadline has not passed.
    Thread-safe; a single denial latches (``exhausted``) so concurrent
    searches stop at the same scheduling decision."""

    def __init__(
        self,
        max_samples: Optional[int] = None,
        deadline_s: Optional[float] = None,
    ):
        self.max_samples = max_samples
        self.deadline_s = deadline_s
        self._t0 = time.monotonic()
        self._granted = 0
        self._lock = threading.Lock()
        self.exhausted = False

    @property
    def granted(self) -> int:
        return self._granted

    def elapsed_s(self) -> float:
        return time.monotonic() - self._t0

    def admit(self, n: int) -> bool:
        with self._lock:
            if self.deadline_s is not None and self.elapsed_s() >= self.deadline_s:
                self.exhausted = True
                return False
            if self.max_samples is not None and self._granted + n > self.max_samples:
                self.exhausted = True
                return False
            self._granted += n
            return True


class SharedBudget:
    """The ``Budget`` surface over cross-process shared state: the granted
    counter and exhausted latch live in shared memory (one admission decision
    fleet-wide), the deadline is an absolute epoch so every process measures
    the same clock. Workers build one from ``Budget.share()``'s spec."""

    def __init__(self, granted, exhausted, max_samples, deadline_epoch):
        self._granted = granted      # multiprocessing.Value("q")
        self._exhausted = exhausted  # multiprocessing.Value("b")
        self.max_samples = max_samples
        self.deadline_epoch = deadline_epoch

    @property
    def granted(self) -> int:
        return int(self._granted.value)

    @property
    def exhausted(self) -> bool:
        return bool(self._exhausted.value)

    def admit(self, n: int) -> bool:
        lock = self._granted.get_lock()
        if not lock.acquire(timeout=BUDGET_LOCK_TIMEOUT_S):
            raise RuntimeError(
                f"the shared budget's lock was not released in "
                f"{BUDGET_LOCK_TIMEOUT_S}s: a worker killed while admitting "
                f"orphaned it"
            )
        try:
            if self._exhausted.value:
                return False
            if self.deadline_epoch is not None and time.time() >= self.deadline_epoch:
                self._exhausted.value = True
                return False
            if (
                self.max_samples is not None
                and self._granted.value + n > self.max_samples
            ):
                self._exhausted.value = True
                return False
            self._granted.value += n
            return True
        finally:
            lock.release()


@dataclasses.dataclass
class SearchRuntime:
    """The durability/scheduling bundle drivers accept as ``runtime=``:
    a shared (possibly durable) record store, a checkpointer, and the
    admission controls. All fields optional — an empty runtime is inert."""

    store: Optional[RecordStore] = None
    checkpoint: Optional[Checkpointer] = None
    budget: Optional[Budget] = None
    stop: Optional[StopToken] = None
    checkpoint_every: int = 1  # batches between periodic saves

    @classmethod
    def at(
        cls,
        checkpoint_dir: Union[str, Path],
        store_path: Optional[Union[str, Path]] = None,
        **kw,
    ) -> "SearchRuntime":
        """Checkpoint/store runtime rooted at paths (the CLI entry point)."""
        store = None if store_path is None else DurableRecordStore(store_path)
        return cls(store=store, checkpoint=Checkpointer(checkpoint_dir), **kw)

    def admit(self, n: int) -> bool:
        if self.stop is not None and self.stop.is_set():
            return False
        if self.budget is not None and not self.budget.admit(n):
            return False
        return True


class _SelfKillRuntime:
    """Wrap a runtime so the process hard-exits after N admissions (the
    ``SELFKILL_ENV`` test hook): the driver has checkpointed the prior
    batches and appended their records to this worker's segment, so death
    lands mid-search with partial durable progress — exactly what a
    preempted worker leaves behind."""

    def __init__(self, inner: SearchRuntime, admits_left: int):
        self._inner = inner
        self._admits_left = admits_left

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def admit(self, n: int) -> bool:
        if self._admits_left <= 0:
            os._exit(137)
        self._admits_left -= 1
        return self._inner.admit(n)


@dataclasses.dataclass
class SearchJob:
    """One named search: ``fn(**kwargs, runtime=, tag=)`` must return a
    ``SearchResult`` (any ``repro_torch.core.search`` driver qualifies)."""

    name: str
    fn: Callable[..., SearchResult]
    kwargs: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class JobOutcome:
    name: str
    status: str  # "done" | "interrupted" | "error"
    result: Optional[SearchResult] = None
    error: Optional[BaseException] = None
    attempts: int = 1  # dispatches it took (1 = no retry was needed)
    # the job failed/crashed on every allowed attempt and was given up on so
    # the rest of the sweep could finish (status is "error")
    quarantined: bool = False


class WorkerCrashed(RuntimeError):
    """A worker process died (kill/preemption/crash) before finishing a job.
    The job's last checkpoint and its segment's appended records survive, so
    a re-run with the same runtime resumes it."""


class WorkerError(RuntimeError):
    """An exception raised inside a worker process, re-raised parent-side
    with the worker's traceback text."""


@dataclasses.dataclass
class ExecutorReport:
    outcomes: dict[str, JobOutcome]
    frontier: ParetoFrontier
    store_stats: Optional[dict]
    wall_s: float
    # process mode extras: wall clock until every worker was imported+ready
    # (torch import + space rebuild), and the job -> worker shard map
    spawn_s: Optional[float] = None
    shards: Optional[dict[str, int]] = None
    # process mode: each worker's seconds from start() to ready, one entry
    # per incarnation (respawns add entries)
    ready_s: Optional[dict[int, list]] = None
    # self-healing counters: retries, respawns, deadline_kills,
    # heartbeat_kills, crashes, quarantined (zero-valued when nothing
    # needed healing)
    recovery: Optional[dict] = None

    @property
    def done(self) -> list[str]:
        return [n for n, o in self.outcomes.items() if o.status == "done"]

    @property
    def interrupted(self) -> list[str]:
        return [n for n, o in self.outcomes.items() if o.status == "interrupted"]

    @property
    def errors(self) -> dict[str, BaseException]:
        return {n: o.error for n, o in self.outcomes.items() if o.status == "error"}

    @property
    def quarantined(self) -> list[str]:
        return [n for n, o in self.outcomes.items() if o.quarantined]


def _ship_error(e: BaseException) -> dict:
    return {"type": type(e).__name__, "repr": repr(e),
            "traceback": traceback.format_exc()}


def _partial_segment_stats(path: Path, offset: int) -> dict:
    """Reconstruct a killed worker's store counters from its segment: every
    complete (newline-terminated) line past the pre-spawn ``offset`` is one
    ``put`` it made this run. gets/hits died with the process — only the
    durable evidence is folded, tagged ``partial_workers`` so reports can
    tell a reconstruction from a clean exit."""
    try:
        with open(path, "rb") as f:
            f.seek(offset)
            appended = f.read().count(b"\n")
    except FileNotFoundError:
        appended = 0
    return {"puts": appended, "appended": appended, "partial_workers": 1}


def visible_cards() -> list[str]:
    """The cards this process sees, as ``CUDA_VISIBLE_DEVICES`` entries (the
    parent's own list when it has one, else indices)."""
    import torch

    count = torch.cuda.device_count()
    env = os.environ.get("CUDA_VISIBLE_DEVICES")
    if env is None:
        return [str(i) for i in range(count)]
    return [c.strip() for c in env.split(",") if c.strip()][:count]


def worker_cards(wid: int, n: int, cards: list[str]) -> list[str]:
    """Worker ``wid``'s ``n`` cards under ``devices_per_worker=n``: the
    entries ``wid·n … wid·n+n−1`` of ``cards``, wrapped around them."""
    if len(cards) < n:
        raise ValueError(
            f"devices_per_worker={n} needs {n} cards per worker; this host "
            f"shows {len(cards)} ({','.join(cards) or 'none'})"
        )
    return [cards[(wid * n + j) % len(cards)] for j in range(n)]


class _Outbox:
    """A worker's end of its own report pipe: whole messages, one thread at
    a time (the job loop and the heartbeat thread share it). A worker killed
    mid-send tears only this pipe, which dies with the incarnation — the
    parent reads its complete messages, then end-of-file (module doc)."""

    def __init__(self, conn):
        self._conn = conn
        self._lock = threading.Lock()

    def put(self, msg) -> None:
        with self._lock:
            self._conn.send(msg)


def _process_worker(
    worker_id: int,
    in_q,
    store_path,
    checkpoint_root,
    checkpoint_every: int,
    budget_spec: Optional[dict],
    stop_event,
    go_event,
    out_conn,
    fault_spec: Optional[str] = None,
    heartbeat_s: Optional[float] = None,
) -> None:
    """Worker main: a persistent job loop. The worker sets up once (torch
    import, store segment, checkpointer), then serves pickled
    ``("job", (job, attempt))`` messages off its input queue — the parent
    dispatches at most one at a time per worker and marks wave boundaries
    with ``("wave_end", None)`` — until the ``None`` sentinel. Reusing the
    process across waves is what amortizes the multi-second spawn cost over
    a whole grid sweep.

    Spawned (not forked): no CUDA state is shared with the parent, and the
    ``CUDA_VISIBLE_DEVICES`` the parent set before start() holds from this
    process's first CUDA call. A daemon heartbeat thread sends ``("hb", id,
    None)`` every ``heartbeat_s`` so the parent can tell hung from busy;
    each job dispatch is acknowledged with a ``("start", ...)`` message that
    starts the parent's per-job deadline clock. At each wave boundary the
    worker ships its *cumulative* store + checkpoint counters
    (``wave_end``); the parent keeps the latest snapshot per worker, which
    aligns with the crash path (segment lines are counted from the
    pool-spawn offset). Every message goes over ``out_conn``, this
    incarnation's own pipe (``_Outbox``). ``fault_spec`` arms a
    deterministic ``repro_torch.runtime.faults`` plan."""
    t_spawn = time.monotonic_ns()  # worker-main entry: the spawn span start
    outbox = _Outbox(out_conn)
    try:
        hb_stop = threading.Event()
        if heartbeat_s:
            def _beat() -> None:
                while not hb_stop.wait(heartbeat_s):
                    try:
                        outbox.put(("hb", worker_id, None))
                    except Exception:  # noqa: BLE001 - parent gone: stop
                        return

            threading.Thread(target=_beat, daemon=True).start()
        # trace enablement crosses the spawn boundary as an env var (like
        # CUDA_VISIBLE_DEVICES); the tracer must exist before the store is
        # built so per-namespace accounting turns on with it
        tracer = obs_trace.start_from_env(worker=worker_id)
        budget = None if budget_spec is None else SharedBudget(**budget_spec)
        store = None
        if store_path is not None:
            store = DurableRecordStore(store_path, segment=worker_id)
        checkpoint = (
            None if checkpoint_root is None else Checkpointer(checkpoint_root)
        )
        injector = None
        plan = faults_lib.FaultPlan.parse(fault_spec)
        if plan:
            # a hung worker stops heartbeating too — "alive but silent" is
            # the failure mode the heartbeat timeout exists for
            injector = faults_lib.FaultInjector(
                plan, process=True, on_hang=hb_stop.set
            )
            checkpoint = injector.checkpointer(checkpoint)
        runtime = SearchRuntime(
            store=store,
            checkpoint=checkpoint,
            budget=budget,
            stop=stop_event,  # multiprocessing.Event has the StopToken surface
            checkpoint_every=checkpoint_every,
        )
        spec = os.environ.get(SELFKILL_ENV)
        if spec:
            wid, _, admits = spec.partition(":")
            if int(wid) == worker_id:
                runtime = _SelfKillRuntime(runtime, int(admits))
        outbox.put(("ready", worker_id, None))
        if go_event is not None:
            go_event.wait()
        if tracer is not None:
            # import + store rehydration + (sync_start) barrier wait — the
            # phase a merged trace shows before the per-job steady state
            tracer.complete_since_ns("worker_spawn", t_spawn, {})
        while True:
            msg = in_q.get()
            if msg is None:  # shutdown sentinel
                break
            kind, payload = msg
            if kind == "wave_end":
                stats: dict = {}
                if store is not None:
                    store.flush()
                    stats = dict(store.stats.as_dict())
                    stats["appended"] = store.appended
                if checkpoint is not None:
                    stats["ckpt_corrupt"] = getattr(checkpoint, "corrupt", 0)
                outbox.put(("wave_end", worker_id, stats or None))
                continue
            job, attempt = pickle.loads(payload)
            outbox.put(
                ("start", worker_id, {"job": job.name, "attempt": attempt})
            )
            job_runtime = runtime
            if injector is not None:
                job_runtime = injector.runtime(runtime, job.name, attempt)
            with obs_trace.span("job", job=job.name, attempt=attempt):
                try:
                    res = job.fn(**job.kwargs, runtime=job_runtime, tag=job.name)
                    outbox.put(("done", job.name, result_state(res)))
                except SearchInterrupted as e:
                    outbox.put(
                        (
                            "interrupted",
                            job.name,
                            {
                                "tag": e.tag,
                                "samples_done": e.samples_done,
                                "samples": e.samples,
                            },
                        )
                    )
                except Exception as e:  # noqa: BLE001 - isolate siblings
                    outbox.put(("error", job.name, _ship_error(e)))
            if injector is not None:
                injector.after_job(job.name, attempt, store)
            if tracer is not None:
                tracer.flush()  # a later hard kill keeps finished-job spans
        hb_stop.set()
        if store is not None:
            store.close()
        outbox.put(("exit", worker_id, None))
    except BaseException as e:  # noqa: BLE001 - ship, don't die silently
        try:
            outbox.put(("fatal", worker_id, _ship_error(e)))
        except Exception:  # noqa: BLE001 - parent gone: nothing to tell
            pass
    finally:
        obs_trace.stop()


@dataclasses.dataclass
class _ProcessPool:
    """A spawned worker fleet kept alive across ``run()`` waves. Slots are
    respawnable: when a worker dies, a fresh process takes over its id (and
    so its single-writer store segment); the dead incarnation's durable
    counters are reconstructed into ``dead_stats`` first."""

    procs: list
    in_qs: list
    # the parent's read end of each slot's report pipe (this incarnation's;
    # None once it reached end-of-file)
    out_conns: list
    cards: Optional[list]  # the parent's visible cards (devices_per_worker)
    stop_event: object
    go_event: object  # None unless sync_start
    budget_spec: Optional[dict]
    store_path: Optional[Path]
    k: int
    t_spawn: float  # monotonic at spawn
    ctx: object  # the spawn context (respawns come from the same one)
    checkpoint_root: Optional[str]
    checkpoint_every: int
    fault_spec: Optional[str]
    heartbeat_s: Optional[float]
    # pre-spawn segment sizes: crash reconstruction counts complete lines
    # appended past these offsets (cumulative, like the shipped counters);
    # advanced to the respawn point when a slot is respawned
    seg_offsets: dict[int, int] = dataclasses.field(default_factory=dict)
    # latest cumulative store counters per worker (wave_end snapshots)
    worker_stats: dict[int, Optional[dict]] = dataclasses.field(
        default_factory=dict
    )
    # reconstructed counters of dead incarnations (one dict per death)
    dead_stats: list[dict] = dataclasses.field(default_factory=list)
    ready: set[int] = dataclasses.field(default_factory=set)
    # monotonic start of each slot's current incarnation, and every
    # incarnation's seconds from start() to its "ready" message (process
    # start, imports, store rehydration)
    t_started: dict[int, float] = dataclasses.field(default_factory=dict)
    ready_s: dict[int, list] = dataclasses.field(default_factory=dict)
    spawn_s: Optional[float] = None
    broken: bool = False  # a worker died/fataled: respawn before reuse

    def receive(self, timeout: float) -> list:
        """Every complete message the live report pipes hold, waiting up to
        ``timeout`` for the first; a pipe at end-of-file (its incarnation
        died, possibly mid-message) is closed and dropped, never waited on."""
        conns = [c for c in self.out_conns if c is not None]
        if not conns:
            time.sleep(timeout)
            return []
        msgs: list = []
        for conn in mp_connection.wait(conns, timeout):
            msgs.extend(self._read(conn))
        return msgs

    def drain(self, wid: int) -> list:
        """The complete messages slot ``wid``'s pipe still holds."""
        conn = self.out_conns[wid]
        return [] if conn is None else self._read(conn)

    def _read(self, conn) -> list:
        msgs = []
        try:
            while conn.poll():
                msgs.append(conn.recv())
        except (EOFError, OSError):
            self.out_conns[self.out_conns.index(conn)] = None
            conn.close()
        return msgs


class SearchExecutor:
    """Run many searches concurrently under one ``SearchRuntime``
    (module doc: threads by default, sharded worker processes with
    ``processes=True``)."""

    def __init__(
        self,
        store: Optional[RecordStore] = None,
        checkpoint: Optional[Checkpointer] = None,
        max_workers: int = 4,
        budget: Optional[Budget] = None,
        checkpoint_every: int = 1,
        objectives=DEFAULT_OBJECTIVES,
        processes: bool = False,
        devices_per_worker: Optional[int] = None,
        sync_start: bool = False,
        persistent: bool = False,
        faults: Optional[Union[str, "faults_lib.FaultPlan"]] = None,
        max_job_retries: int = 3,
        retry_backoff_s: float = 0.1,
        job_deadline_s: Optional[float] = None,
        heartbeat_s: Optional[float] = 0.5,
        heartbeat_timeout_s: Optional[float] = 300.0,
    ):
        self.max_workers = max_workers
        self.objectives = objectives
        self.processes = processes
        # deterministic fault plan (spec string or FaultPlan); None falls
        # back to the REPRO_FAULTS env var, which also crosses spawn
        if isinstance(faults, faults_lib.FaultPlan):
            faults = faults.spec()
        self.fault_spec = (
            faults if faults is not None
            else os.environ.get(faults_lib.FAULTS_ENV)
        )
        # self-healing policy: a failed/crashed job is re-dispatched up to
        # max_job_retries times with exponential backoff before being
        # quarantined; job_deadline_s bounds a single attempt's wall clock
        # (straggler/hang detection); heartbeat_timeout_s bounds worker
        # silence while a job is in flight
        self.max_job_retries = max_job_retries
        self.retry_backoff_s = retry_backoff_s
        self.job_deadline_s = job_deadline_s
        self.heartbeat_s = heartbeat_s
        self.heartbeat_timeout_s = heartbeat_timeout_s
        # keep the spawned worker pool alive across run() calls: follow-up
        # waves (e.g. the transfer scheduler's warm fan-out) reuse the
        # already-imported workers instead of paying the multi-second spawn
        # again. The pool is sized max_workers regardless of the first
        # wave's job count; call close() (or use the executor as a context
        # manager) when done. Default off: one-shot runs then tear the
        # workers down on return, exactly as before.
        self.persistent = persistent
        self._pool: Optional[_ProcessPool] = None
        # N cards of its own for each worker (CUDA_VISIBLE_DEVICES, see
        # worker_cards); None: every worker sees every card the parent sees
        self.devices_per_worker = devices_per_worker
        # hold every worker at a barrier until all are imported+ready, and
        # report the setup time as report.spawn_s — lets benchmarks separate
        # one-time process spin-up from steady-state search throughput
        self.sync_start = sync_start
        self.stop_token = StopToken()
        self.runtime = SearchRuntime(
            store=store,
            checkpoint=checkpoint,
            budget=budget,
            stop=self.stop_token,
            checkpoint_every=checkpoint_every,
        )

    def stop(self, reason: str = "stop requested") -> None:
        """Graceful stop: in-flight searches checkpoint at their next batch
        boundary and report ``interrupted`` (process workers see the mirrored
        event)."""
        self.stop_token.set(reason)

    def close(self) -> None:
        """Shut down the process-worker pool: send each worker its shutdown
        sentinel, drain the result queue (a worker's put must never block on
        a full pipe while the parent joins), join, and terminate stragglers.
        Safe to call repeatedly; a no-op in thread mode or when no pool is
        live. Non-persistent executors call this automatically at the end of
        every ``run()``."""
        pool, self._pool = self._pool, None
        if pool is None:
            return
        for q in pool.in_qs:
            try:
                q.put(None)
            except Exception:  # noqa: BLE001 - queue may be broken post-crash
                pass
        if pool.go_event is not None:
            pool.go_event.set()  # never leave a worker parked at the barrier
        deadline = time.monotonic() + 30.0
        while any(p.is_alive() for p in pool.procs):
            if time.monotonic() > deadline:
                break
            pool.receive(0.1)
        for p in pool.procs:
            p.join(timeout=5.0)
            if p.is_alive():
                p.kill()
                p.join(timeout=5.0)
        for q in pool.in_qs:
            # a dead worker never read its queue: do not let the feeder
            # thread hold the parent's exit on it
            q.cancel_join_thread()
            q.close()
        for conn in pool.out_conns:
            if conn is not None:
                conn.close()
        self.stop_token.unmirror(pool.stop_event)

    def __enter__(self) -> "SearchExecutor":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def run(self, jobs: list[SearchJob]) -> ExecutorReport:
        """Execute all jobs (at most ``max_workers`` at a time); never
        raises on a per-search failure — inspect ``report.outcomes``."""
        names = [j.name for j in jobs]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate job names: {names}")
        if self.processes:
            return self._run_processes(jobs)
        t0 = time.monotonic()
        # thread mode arms only the shared-process-safe faults (exc/slow/
        # ckpt/torn): a crash would kill the whole pool, a hang would hang it
        injector = None
        plan = faults_lib.FaultPlan.parse(self.fault_spec)
        runtime = self.runtime
        if plan:
            injector = faults_lib.FaultInjector(plan, process=False)
            if runtime.checkpoint is not None:
                runtime = dataclasses.replace(
                    runtime, checkpoint=injector.checkpointer(runtime.checkpoint)
                )

        def interrupted_now() -> bool:
            budget = self.runtime.budget
            return self.stop_token.is_set() or (
                budget is not None and budget.exhausted
            )

        def run_one(job: SearchJob) -> JobOutcome:
            attempt = 0
            while True:
                job_runtime = runtime
                if injector is not None:
                    job_runtime = injector.runtime(runtime, job.name, attempt)
                try:
                    with obs_trace.span("job", job=job.name, attempt=attempt):
                        res = job.fn(
                            **job.kwargs, runtime=job_runtime, tag=job.name
                        )
                    return JobOutcome(
                        job.name, "done", result=res, attempts=attempt + 1
                    )
                except SearchInterrupted as e:
                    return JobOutcome(
                        job.name, "interrupted", error=e, attempts=attempt + 1
                    )
                except Exception as e:  # noqa: BLE001 - isolate siblings
                    attempt += 1
                    if interrupted_now() or attempt > self.max_job_retries:
                        return JobOutcome(
                            job.name, "error", error=e, attempts=attempt,
                            quarantined=(
                                not interrupted_now()
                                and self.max_job_retries > 0
                            ),
                        )
                    tr = obs_trace.active()
                    if tr is not None:
                        tr.instant(
                            "job_retry", {"job": job.name, "attempt": attempt}
                        )
                    time.sleep(self._backoff_s(attempt))
                finally:
                    if injector is not None:
                        injector.after_job(job.name, attempt, self.runtime.store)

        with ThreadPoolExecutor(max_workers=self.max_workers) as pool:
            outcomes = list(pool.map(run_one, jobs))

        frontier = ParetoFrontier(self.objectives)
        for o in outcomes:
            if o.result is not None:
                frontier.add_many(o.result.history)
        store = self.runtime.store
        if isinstance(store, DurableRecordStore):
            store.flush()
        return ExecutorReport(
            outcomes={o.name: o for o in outcomes},
            frontier=frontier,
            store_stats=None if store is None else store.stats.as_dict(),
            wall_s=time.monotonic() - t0,
            recovery={
                "retries": sum(o.attempts - 1 for o in outcomes),
                "respawns": 0,
                "deadline_kills": 0,
                "heartbeat_kills": 0,
                "crashes": 0,
                "quarantined": sum(1 for o in outcomes if o.quarantined),
            },
        )

    def _backoff_s(self, attempt: int) -> float:
        """Exponential retry backoff, capped so a late retry never stalls a
        sweep longer than a couple of seconds."""
        return min(self.retry_backoff_s * (2.0 ** max(attempt - 1, 0)), 2.0)

    # ---- process mode -----------------------------------------------------

    def _store_path(self) -> Optional[Path]:
        store = self.runtime.store
        if store is None:
            return None
        if not isinstance(store, DurableRecordStore):
            raise ValueError(
                "process mode shares evaluations through a DurableRecordStore "
                "(workers append to per-worker segments of its log); an "
                "in-memory RecordStore cannot cross process boundaries — "
                "pass a durable store or store=None (private worker caches)"
            )
        if store.read_only or store.segment is not None:
            raise ValueError(
                "process mode needs the writable base store (not read_only, "
                "not itself a segment writer)"
            )
        return store.path

    @staticmethod
    def _shard(jobs: list[SearchJob], k: int) -> list[list[SearchJob]]:
        """Deterministic round-robin partition: job i -> worker i % k."""
        return [jobs[i::k] for i in range(k)]

    @contextlib.contextmanager
    def _spawn_env(self, pool: _ProcessPool, wid: int):
        """Card / trace-dir handoff for spawned workers: set the env vars
        for slot ``wid``'s child, restore the parent's values right after
        ``start()`` — initial spawns and slot respawns take the same path."""
        parent_tracer = obs_trace.active()
        saved = {
            name: os.environ.get(name)
            for name in ("CUDA_VISIBLE_DEVICES", obs_trace.TRACE_DIR_ENV)
        }
        if self.devices_per_worker:
            os.environ["CUDA_VISIBLE_DEVICES"] = ",".join(
                worker_cards(wid, self.devices_per_worker, pool.cards)
            )
        if parent_tracer is not None:
            os.environ[obs_trace.TRACE_DIR_ENV] = str(parent_tracer.dir)
        try:
            yield
        finally:
            for name, value in saved.items():
                if value is None:
                    os.environ.pop(name, None)
                else:
                    os.environ[name] = value

    def _start_slot(self, pool: _ProcessPool, wid: int) -> None:
        """Start (or restart) slot ``wid`` on a *fresh* input queue and
        report pipe — a message dispatched to the dead incarnation but never
        read must not leak into the new one, and a message it tore must not
        reach the parent."""
        old_q, old_conn = pool.in_qs[wid], pool.out_conns[wid]
        if old_q is not None:
            old_q.cancel_join_thread()
            old_q.close()
        if old_conn is not None:
            old_conn.close()
        in_q = pool.ctx.Queue()
        pool.in_qs[wid] = in_q
        out_r, out_w = pool.ctx.Pipe(duplex=False)
        p = pool.ctx.Process(
            target=_process_worker,
            args=(
                wid,
                in_q,
                pool.store_path,
                pool.checkpoint_root,
                pool.checkpoint_every,
                pool.budget_spec,
                pool.stop_event,
                pool.go_event,
                out_w,
                pool.fault_spec,
                pool.heartbeat_s,
            ),
            daemon=True,
        )
        with self._spawn_env(pool, wid):
            p.start()
        # only the child holds the write end now: its death is end-of-file
        out_w.close()
        pool.out_conns[wid] = out_r
        pool.procs[wid] = p
        pool.t_started[wid] = time.monotonic()

    def _spawn_pool(self, k: int, store_path: Optional[Path]) -> _ProcessPool:
        """Spawn ``k`` persistent workers (queues, events, shared budget,
        env handoff) — everything that used to happen per ``run()`` now
        happens once per pool."""
        runtime = self.runtime
        t_spawn = time.monotonic()
        # pre-spawn segment sizes: if a worker dies before shipping its
        # counters, the complete lines it appended past this offset are the
        # durable record of the work it did (folded into the aggregate)
        seg_offsets: dict[int, int] = {}
        if store_path is not None:
            for wid in range(k):
                seg = store_path.with_name(f"{store_path.name}{_SEGMENT_INFIX}{wid}")
                try:
                    seg_offsets[wid] = seg.stat().st_size
                except FileNotFoundError:
                    seg_offsets[wid] = 0
        ctx = multiprocessing.get_context("spawn")  # CUDA cannot run in a fork
        stop_event = ctx.Event()
        self.stop_token.mirror(stop_event)
        go_event = ctx.Event() if self.sync_start else None
        budget_spec = None
        budget = runtime.budget
        if budget is not None:
            deadline_epoch = None
            if budget.deadline_s is not None:
                deadline_epoch = time.time() + max(
                    budget.deadline_s - budget.elapsed_s(), 0.0
                )
            budget_spec = dict(
                granted=ctx.Value("q", budget.granted),
                exhausted=ctx.Value("b", budget.exhausted),
                max_samples=budget.max_samples,
                deadline_epoch=deadline_epoch,
            )
        checkpoint_root = (
            None if runtime.checkpoint is None else str(runtime.checkpoint.root)
        )
        cards = None
        if self.devices_per_worker:
            cards = visible_cards()
            worker_cards(0, self.devices_per_worker, cards)  # raises if too few
        pool = _ProcessPool(
            procs=[None] * k,
            in_qs=[None] * k,
            out_conns=[None] * k,
            cards=cards,
            stop_event=stop_event,
            go_event=go_event,
            budget_spec=budget_spec,
            store_path=store_path,
            k=k,
            t_spawn=t_spawn,
            ctx=ctx,
            checkpoint_root=checkpoint_root,
            checkpoint_every=runtime.checkpoint_every,
            fault_spec=self.fault_spec,
            heartbeat_s=self.heartbeat_s,
            seg_offsets=seg_offsets,
        )
        for wid in range(k):
            self._start_slot(pool, wid)
        return pool

    def _ensure_pool(self, n_jobs: int, store_path: Optional[Path]) -> tuple:
        """The live pool, respawning after a crash; returns (pool, spawned).
        Persistent pools are sized ``max_workers`` up front (later waves may
        be wider than the first); one-shot pools shrink to the job count."""
        pool = self._pool
        if pool is not None and (
            pool.broken or any(not p.is_alive() for p in pool.procs)
        ):
            self.close()
            pool = None
        if pool is not None:
            return pool, False
        if self.persistent:
            k = max(1, self.max_workers)
        else:
            k = max(1, min(self.max_workers, n_jobs))
        pool = self._spawn_pool(k, store_path)
        self._pool = pool
        return pool, True

    def _run_processes(self, jobs: list[SearchJob]) -> ExecutorReport:
        t0 = time.monotonic()
        parent_tracer = obs_trace.active()
        t_trace = parent_tracer.now() if parent_tracer is not None else 0.0
        runtime = self.runtime
        store_path = self._store_path()
        # before any worker exists: a job that cannot cross the spawn
        # boundary fails here, not after the pool's start-up
        for job in jobs:
            try:
                pickle.dumps(job)
            except Exception as e:
                raise ValueError(
                    f"process mode ships jobs by pickle and job {job.name!r} "
                    f"does not serialize ({e}); use registry spaces "
                    f"(repro_torch.core.nas.SPACES / has.has_space — they carry "
                    f"pickle provenance) and a picklable backend, or run "
                    f"thread mode (processes=False)"
                ) from e
        pool, spawned = self._ensure_pool(len(jobs), store_path)
        shards = self._shard(jobs, pool.k)
        shard_of = {job.name: wid for wid, shard in enumerate(shards) for job in shard}
        jobs_by_name = {j.name: j for j in jobs}

        # per-slot FIFOs keep the deterministic round-robin layout; jobs a
        # dead slot leaves behind, and retry-able failures, go through
        # retry_q and may land on any idle worker (trajectories are
        # placement-independent, so healing never changes results)
        slot_q: dict[int, list[SearchJob]] = {
            wid: list(shard) for wid, shard in enumerate(shards)
        }
        retry_q: list[tuple[float, str]] = []  # (monotonic ready-at, job name)
        attempts: dict[str, int] = {j.name: 0 for j in jobs}  # failed so far
        inflight: dict[int, dict] = {}  # wid -> {name, attempt, t_start}
        outcomes: dict[str, JobOutcome] = {}
        fatals: dict[int, dict] = {}
        dead_slots: set[int] = set()  # slots given up on (fatal/cap/stop)
        last_hb: dict[int, float] = {
            wid: time.monotonic() for wid in range(pool.k)
        }
        recovery = {
            "retries": 0,
            "respawns": 0,
            "deadline_kills": 0,
            "heartbeat_kills": 0,
            "crashes": 0,
            "quarantined": 0,
        }
        # a runaway fault schedule must still terminate: past this many
        # respawns, remaining jobs fall back to "re-run to resume"
        max_respawns = self.max_job_retries * len(jobs) + pool.k

        def interrupted_now() -> bool:
            if self.stop_token.is_set():
                return True
            budget = runtime.budget
            if budget is not None and budget.exhausted:
                return True
            spec = pool.budget_spec
            return spec is not None and bool(spec["exhausted"].value)

        def owner_of(name: str) -> Optional[int]:
            for wid, info in inflight.items():
                if info["name"] == name:
                    return wid
            return None

        def schedule_retry(name: str, err: BaseException) -> None:
            """A failed attempt: retry with backoff, or quarantine so one
            poison job cannot take the sweep down with it."""
            att = attempts[name] + 1
            attempts[name] = att
            if att > self.max_job_retries:
                recovery["quarantined"] += 1
                outcomes[name] = JobOutcome(
                    name,
                    "error",
                    error=err,
                    attempts=att,
                    quarantined=self.max_job_retries > 0,
                )
                return
            recovery["retries"] += 1
            retry_q.append((time.monotonic() + self._backoff_s(att), name))
            if parent_tracer is not None:
                parent_tracer.instant(
                    "job_retry", {"job": name, "attempt": att}
                )

        def account_dead_incarnation(wid: int) -> None:
            """Fold the dead incarnation's durable segment lines into
            ``dead_stats`` and advance the offset so the next incarnation's
            counters start clean (no double counting)."""
            if store_path is None:
                return
            seg = store_path.with_name(f"{store_path.name}{_SEGMENT_INFIX}{wid}")
            pool.dead_stats.append(
                _partial_segment_stats(seg, pool.seg_offsets.get(wid, 0))
            )
            try:
                pool.seg_offsets[wid] = seg.stat().st_size
            except FileNotFoundError:
                pool.seg_offsets[wid] = 0
            pool.worker_stats.pop(wid, None)

        def retire_slot(wid: int, err_for_pending: BaseException) -> None:
            """Give up on a slot: its queued jobs spill to the retry queue
            if anyone is left to run them, else they report ``err``."""
            dead_slots.add(wid)
            spill = [j for j in slot_q[wid] if j.name not in outcomes]
            slot_q[wid] = []
            fleet_alive = any(
                w not in dead_slots and pool.procs[w].is_alive()
                for w in range(pool.k)
            )
            for job in spill:
                if fleet_alive:
                    retry_q.append((time.monotonic(), job.name))
                else:
                    outcomes[job.name] = JobOutcome(
                        job.name, "interrupted", error=err_for_pending
                    )

        def slot_died(wid: int) -> None:
            p = pool.procs[wid]
            info = inflight.pop(wid, None)
            account_dead_incarnation(wid)
            if wid in fatals:
                # the worker shipped its own setup/protocol failure: a
                # respawn would just hit it again — error out its jobs
                err = WorkerError(
                    f"{fatals[wid]['repr']}\n{fatals[wid]['traceback']}"
                )
                if info is not None and info["name"] not in outcomes:
                    outcomes[info["name"]] = JobOutcome(
                        info["name"], "error", error=err,
                        attempts=attempts[info["name"]] + 1,
                    )
                for job in slot_q[wid]:
                    if job.name not in outcomes:
                        outcomes[job.name] = JobOutcome(
                            job.name, "error", error=err
                        )
                slot_q[wid] = []
                dead_slots.add(wid)
                return
            recovery["crashes"] += 1
            crash_err = WorkerCrashed(
                f"worker {wid} exited (code {p.exitcode}) before finishing "
                f"its job; its checkpoints and store segment survive — "
                f"re-run to resume"
            )
            if interrupted_now():
                # budget/stop is taking the run down: keep the pre-healing
                # contract (interrupted outcome, resumable by a re-run)
                if info is not None and info["name"] not in outcomes:
                    outcomes[info["name"]] = JobOutcome(
                        info["name"], "interrupted", error=crash_err,
                        attempts=attempts[info["name"]] + 1,
                    )
                retire_slot(wid, crash_err)
                return
            if info is not None and info["name"] not in outcomes:
                schedule_retry(info["name"], crash_err)
            if (
                recovery["respawns"] >= max_respawns
                or len(outcomes) >= len(jobs)
            ):
                retire_slot(wid, crash_err)
                return
            # heal the slot: a fresh incarnation takes over the worker id
            # (and with it the single-writer segment), resuming retried
            # jobs from their surviving checkpoints
            self._start_slot(pool, wid)
            pool.ready.discard(wid)
            last_hb[wid] = time.monotonic()
            recovery["respawns"] += 1
            if parent_tracer is not None:
                parent_tracer.instant("worker_respawn", {"worker": wid})

        def kill_slot(wid: int, why: str, counter: str) -> None:
            """Hung/straggling worker: kill it dead *before* the slot is
            respawned so the old incarnation can never write to the segment
            again (single-writer stays true), then let the death path heal."""
            recovery[counter] += 1
            if parent_tracer is not None:
                parent_tracer.instant(
                    "worker_kill", {"worker": wid, "why": why}
                )
            p = pool.procs[wid]
            kill = getattr(p, "kill", p.terminate)
            kill()
            p.join(timeout=10.0)

        def handle(kind: str, who, payload) -> None:
            now = time.monotonic()
            if kind == "ready":
                pool.ready.add(who)
                pool.ready_s.setdefault(who, []).append(
                    now - pool.t_started[who]
                )
                last_hb[who] = now
            elif kind == "hb":
                last_hb[who] = now
            elif kind == "start":
                last_hb[who] = now
                info = inflight.get(who)
                if info is not None and info["name"] == payload["job"]:
                    info["t_start"] = now
            elif kind == "done":
                wid = owner_of(who)
                if wid is not None:
                    inflight.pop(wid)
                outcomes[who] = JobOutcome(
                    who,
                    "done",
                    result=result_from_state(payload, None),
                    attempts=attempts.get(who, 0) + 1,
                )
            elif kind == "interrupted":
                wid = owner_of(who)
                if wid is not None:
                    inflight.pop(wid)
                outcomes[who] = JobOutcome(
                    who,
                    "interrupted",
                    error=SearchInterrupted(
                        payload["tag"], payload["samples_done"], payload["samples"]
                    ),
                    attempts=attempts.get(who, 0) + 1,
                )
            elif kind == "error":
                wid = owner_of(who)
                if wid is not None:
                    inflight.pop(wid)
                err = WorkerError(f"{payload['repr']}\n{payload['traceback']}")
                if interrupted_now():
                    outcomes[who] = JobOutcome(
                        who, "error", error=err,
                        attempts=attempts.get(who, 0) + 1,
                    )
                else:
                    schedule_retry(who, err)
            elif kind == "wave_end":
                pool.worker_stats[who] = payload
            elif kind == "fatal":
                fatals[who] = payload

        def next_for(wid: int) -> Optional[SearchJob]:
            while slot_q[wid]:
                job = slot_q[wid].pop(0)
                if job.name not in outcomes:
                    return job
            now = time.monotonic()
            for i, (ready_at, name) in enumerate(retry_q):
                if ready_at <= now and name not in outcomes:
                    del retry_q[i]
                    return jobs_by_name[name]
            return None

        while len(outcomes) < len(jobs):
            now = time.monotonic()
            go_event = pool.go_event
            if go_event is not None and not go_event.is_set():
                if pool.spawn_s is None and len(pool.ready) >= pool.k:
                    pool.spawn_s = time.monotonic() - pool.t_spawn
                    if parent_tracer is not None:
                        parent_tracer.complete(
                            "spawn_barrier", t_trace, {"workers": pool.k}
                        )
                    go_event.set()
                elif not any(p.is_alive() for p in pool.procs):
                    go_event.set()  # never gate survivors on a dead worker
            # dispatch: at most one in-flight job per live worker
            for wid in range(pool.k):
                if wid in dead_slots or wid in inflight:
                    continue
                if not pool.procs[wid].is_alive():
                    continue  # the death scan below handles it
                nxt = next_for(wid)
                if nxt is None:
                    continue
                att = attempts[nxt.name]
                pool.in_qs[wid].put(("job", pickle.dumps((nxt, att))))
                inflight[wid] = {
                    "name": nxt.name,
                    "attempt": att,
                    "t_disp": now,
                    "t_start": None,
                }
            # drain: a worker's send must never block on a full pipe while
            # the parent waits
            for msg in pool.receive(0.05):
                handle(*msg)
            # death scan (kill_slot victims land here too)
            for wid in range(pool.k):
                if wid in dead_slots or pool.procs[wid].is_alive():
                    continue
                # read everything it sent before dying first — a complete
                # "done" beats a crash re-dispatch; a torn last message is
                # end-of-file, never a wait
                for msg in pool.drain(wid):
                    handle(*msg)
                if wid in dead_slots or pool.procs[wid].is_alive():
                    continue
                slot_died(wid)
            # straggler detection: a job past its deadline forfeits the
            # worker (the job itself is retried on a fresh incarnation)
            if self.job_deadline_s is not None:
                for wid, info in list(inflight.items()):
                    if wid in dead_slots or not pool.procs[wid].is_alive():
                        continue
                    t_start = info.get("t_start")
                    if t_start is None:
                        continue  # deadline clock starts at the ack
                    if now - t_start > self.job_deadline_s:
                        kill_slot(
                            wid,
                            f"job {info['name']!r} over deadline "
                            f"{self.job_deadline_s}s",
                            "deadline_kills",
                        )
            # heartbeat timeout: a busy worker gone silent is hung even if
            # the kernel still counts it alive — and so is one holding a job
            # that never reported ready since its (re)spawn (module doc)
            if self.heartbeat_s and self.heartbeat_timeout_s:
                for wid in list(inflight):
                    if wid in dead_slots or not pool.procs[wid].is_alive():
                        continue
                    if now - last_hb[wid] > self.heartbeat_timeout_s:
                        kill_slot(wid, "heartbeat timeout", "heartbeat_kills")
            if all(
                wid in dead_slots or not pool.procs[wid].is_alive()
                for wid in range(pool.k)
            ) and len(outcomes) < len(jobs):
                # whole fleet gone and not coming back: the remaining jobs
                # keep the pre-healing resumable contract
                for name in attempts:
                    if name not in outcomes:
                        outcomes[name] = JobOutcome(
                            name,
                            "interrupted",
                            error=WorkerCrashed(
                                f"worker fleet lost before finishing "
                                f"{name!r}; checkpoints and store segments "
                                f"survive — re-run to resume"
                            ),
                        )
                break

        # wave boundary: collect cumulative counters from the live fleet
        live = [
            wid
            for wid in range(pool.k)
            if wid not in dead_slots and pool.procs[wid].is_alive()
        ]
        for wid in live:
            try:
                pool.in_qs[wid].put(("wave_end", None))
            except Exception:  # noqa: BLE001 - queue may be broken post-crash
                pass
        waiting = set(live)
        wave_deadline = time.monotonic() + 30.0
        while waiting and time.monotonic() < wave_deadline:
            for kind, who, payload in pool.receive(0.2):
                handle(kind, who, payload)
                if kind in ("wave_end", "fatal"):
                    waiting.discard(who)
            for wid in list(waiting):
                if not pool.procs[wid].is_alive() and pool.out_conns[wid] is None:
                    waiting.discard(wid)
        if fatals or dead_slots:
            pool.broken = True  # next run() respawns a clean fleet
        spawn_s = pool.spawn_s if spawned else None

        # sync shared-budget consumption back into the parent's Budget so the
        # caller's accounting (e.g. CLI summaries) reflects worker admissions
        budget = runtime.budget
        if budget is not None and pool.budget_spec is not None:
            with budget._lock:
                budget._granted = int(pool.budget_spec["granted"].value)
                budget.exhausted = bool(pool.budget_spec["exhausted"].value)

        frontier = ParetoFrontier(self.objectives)
        for name in (j.name for j in jobs):
            o = outcomes[name]
            if o.result is not None:
                frontier.add_many(o.result.history)

        store = runtime.store
        store_stats = None
        if store is not None:
            store.refresh()  # log shipping: fold worker segments into memory
            store.flush()
            # counters are cumulative since (re)spawn: every dead
            # incarnation was reconstructed from its durable segment lines
            # into dead_stats when it died; live slots contribute their
            # latest wave_end snapshot (or a reconstruction if it never
            # shipped one)
            stats_list = list(pool.dead_stats)
            for wid in range(pool.k):
                if wid in dead_slots:
                    continue  # fully accounted in dead_stats
                snap = pool.worker_stats.get(wid)
                if snap is not None:
                    stats_list.append(snap)
                else:
                    stats_list.append(
                        _partial_segment_stats(
                            store_path.with_name(
                                f"{store_path.name}{_SEGMENT_INFIX}{wid}"
                            ),
                            pool.seg_offsets.get(wid, 0),
                        )
                    )
            store_stats = self._aggregate_stats(stats_list)
        if parent_tracer is not None:
            parent_tracer.complete(
                "executor_run", t_trace, {"jobs": len(jobs), "workers": pool.k}
            )
        report = ExecutorReport(
            outcomes={name: outcomes[name] for name in (j.name for j in jobs)},
            frontier=frontier,
            store_stats=store_stats,
            wall_s=time.monotonic() - t0,
            spawn_s=spawn_s,
            shards=shard_of,
            ready_s={wid: list(s) for wid, s in pool.ready_s.items()},
            recovery=recovery,
        )
        if not self.persistent:
            self.close()
        return report

    @staticmethod
    def _aggregate_stats(stats: list[dict]) -> dict:
        """Fold the workers' per-segment store counters into one report with
        the same shape a shared thread-mode store produces. Routed through
        ``repro_torch.obs.metrics.merge_stats``: counters sum, ``hit_rate`` /
        ``cross_hit_rate`` are recomputed from the summed counters (never
        summed or averaged), and any extra keys a worker ships (e.g.
        ``partial_workers`` from a crash reconstruction) fold in instead of
        being dropped."""
        total = obs_metrics.merge_stats(
            stats,
            defaults={
                "gets": 0,
                "hits": 0,
                "cross_hits": 0,
                "puts": 0,
                "evictions": 0,
                "appended": 0,
            },
        )
        total["workers"] = len(stats)
        return total


def scenario_jobs(
    scenarios,
    nas_space,
    acc_fn,
    cfg=None,
    driver: str = "joint",
    backend=None,
    transfer_specs=None,
) -> list[SearchJob]:
    """One ``SearchJob`` per scenario over one driver — the concurrent
    counterpart of ``sweep.SweepRunner`` (same tags, so the two are
    checkpoint-compatible: a sweep interrupted serially can resume under the
    executor and vice versa). ``transfer_specs`` maps scenario name ->
    ``search.TransferSpec`` for scenarios that should warm-start from a
    solved neighbor's checkpoint (joint/fixed_hw drivers only)."""
    from repro_torch.core import scenarios as scenarios_lib
    from repro_torch.core import sweep as sweep_lib
    from repro_torch.core.proxy import CachedAccuracy
    from repro_torch.core.search import SearchConfig

    if driver not in sweep_lib.DRIVERS:
        raise ValueError(
            f"unknown driver {driver!r} (one of {sorted(sweep_lib.DRIVERS)})"
        )
    if transfer_specs and driver not in ("joint", "fixed_hw"):
        raise ValueError(
            f"transfer_specs warm-starts a single controller and only the "
            f"joint/fixed_hw drivers have one; driver {driver!r} does not "
            f"support transfer"
        )
    if not isinstance(acc_fn, CachedAccuracy):
        acc_fn = CachedAccuracy(acc_fn)
    cfg = cfg or SearchConfig()
    jobs = []
    for sc in scenarios_lib.expand(scenarios):
        kwargs = dict(
            nas_space=nas_space,
            acc_fn=acc_fn,
            cfg=cfg,
            backend=backend,
            scenario=sc,
        )
        spec = None if transfer_specs is None else transfer_specs.get(sc.name)
        if spec is not None:
            kwargs["transfer"] = spec
        jobs.append(
            SearchJob(
                name=f"sweep.{sc.name}",
                fn=sweep_lib.DRIVERS[driver],
                kwargs=kwargs,
            )
        )
    return jobs
