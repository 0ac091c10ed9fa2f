"""Deterministic fault injection for the search runtime.

Chaos testing only earns its keep when a failing run can be replayed: every
fault here is keyed by *what* the runtime is doing (job name, attempt
number, admission count, checkpoint save count) — never by wall clock or an
unseeded RNG — so the same ``FaultPlan`` against the same sweep produces the
same fault schedule on every machine, and the recovery invariant ("winners
identical to the fault-free run") is a reproducible assertion rather than a
flaky one.

A plan is a semicolon-separated spec, usable programmatically
(``FaultPlan.parse`` / ``FaultPlan.sample``) or through the ``REPRO_FAULTS``
environment variable, which crosses the executor's spawn boundary the same
way ``CUDA_VISIBLE_DEVICES`` does:

* ``crash:<job>:<attempt>:<admits>`` — hard-exit the worker (``os._exit``,
  as a kill -9 would) on the job's Nth admission of that attempt;
  ``admits=0`` dies at the job boundary, before any work.
* ``hang:<job>:<attempt>:<admits>`` — stop heartbeating and sleep forever;
  only the parent's job deadline / heartbeat timeout can end the wave.
* ``exc:<job>:<n>:<admits>`` — raise ``TransientFault`` on every attempt
  below ``n`` (so attempt ``n`` finally succeeds): the retry-with-backoff
  path, resumed from whatever the earlier attempts checkpointed.
* ``slow:<job>:<attempt>:<seconds>`` — a straggler: sleep before the job's
  first admission of that attempt.
* ``torn:<job>:<attempt>`` — after the job finishes, append one corrupt
  line plus one torn (newline-less) fragment to the worker's store segment.
* ``ckpt:<tag>:<nth>`` — flip a byte in the checkpoint file after its Nth
  ``save`` of that tag: the digest check must degrade the next load to a
  cold restart, not an unpickling crash.

``FaultInjector`` is the runtime side: workers arm it per job attempt
(``runtime()`` wraps the job's ``SearchRuntime`` so crash/hang/exc/slow
fire at admission boundaries, like the ``_SelfKillRuntime`` test hook),
wrap their checkpointer (``checkpointer()``) and call ``after_job()`` for
torn-store injection. Thread mode arms only the faults that make sense in
a shared process (exc/slow/ckpt/torn — a "crash" would kill the whole
pool, a "hang" would hang it).

Counterpart of ``repro/runtime/faults.py``: a copy (stdlib ``random``, so a
plan's ``parse``/``spec``/``sample`` equal the reference's bitwise).
"""

from __future__ import annotations

import dataclasses
import os
import random
import time
from typing import Callable, Optional, Sequence

from repro_torch.obs import trace as obs_trace

# the env spec the executor forwards to spawned workers (parent resolves it
# once per run so programmatic plans and env plans take the same path)
FAULTS_ENV = "REPRO_FAULTS"

KINDS = ("crash", "hang", "exc", "slow", "torn", "ckpt")

# faults that are safe to arm inside a shared (thread-mode) process
THREAD_SAFE_KINDS = ("exc", "slow", "torn", "ckpt")


class TransientFault(RuntimeError):
    """The injected transient job failure (``exc:`` events)."""


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault. ``attempt`` is the job attempt it fires on —
    except for ``exc`` (fires on every attempt *below* it) and ``ckpt``
    (the save ordinal it corrupts). ``admits`` is the admission count
    within the job at which crash/hang/exc/slow fire; ``arg`` is the
    ``slow`` sleep in seconds."""

    kind: str
    target: str  # job name, or checkpoint tag for ckpt
    attempt: int = 0
    admits: int = 0
    arg: float = 0.0

    def spec(self) -> str:
        if self.kind == "slow":
            return f"slow:{self.target}:{self.attempt}:{self.arg:g}"
        if self.kind == "torn":
            return f"torn:{self.target}:{self.attempt}"
        if self.kind == "ckpt":
            return f"ckpt:{self.target}:{self.attempt}"
        return f"{self.kind}:{self.target}:{self.attempt}:{self.admits}"


def _parse_event(entry: str) -> FaultEvent:
    parts = entry.split(":")
    kind = parts[0].strip()
    if kind not in KINDS:
        raise ValueError(
            f"unknown fault kind {kind!r} in {entry!r} (one of {KINDS})"
        )
    if len(parts) < 2 or not parts[1]:
        raise ValueError(f"fault entry {entry!r} names no target job/tag")
    target = parts[1]

    def num(i: int, default: int) -> int:
        return int(parts[i]) if len(parts) > i and parts[i] != "" else default

    if kind == "slow":
        if len(parts) < 4:
            raise ValueError(
                f"slow fault {entry!r} needs slow:<job>:<attempt>:<seconds>"
            )
        return FaultEvent(kind, target, attempt=num(2, 0), arg=float(parts[3]))
    if kind in ("torn", "ckpt"):
        return FaultEvent(kind, target, attempt=num(2, 0))
    # crash / hang / exc
    default_admits = 1 if kind == "exc" else 0
    return FaultEvent(
        kind,
        target,
        attempt=num(2, 1 if kind == "exc" else 0),
        admits=num(3, default_admits),
    )


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """An immutable fault schedule (module doc for the spec grammar)."""

    events: tuple[FaultEvent, ...] = ()

    @classmethod
    def parse(cls, spec: Optional[str]) -> "FaultPlan":
        if not spec or not spec.strip():
            return cls()
        events = tuple(
            _parse_event(entry.strip())
            for entry in spec.split(";")
            if entry.strip()
        )
        return cls(events)

    @classmethod
    def from_env(cls) -> "FaultPlan":
        return cls.parse(os.environ.get(FAULTS_ENV))

    def spec(self) -> str:
        """The round-trippable spec string (``parse(plan.spec()) == plan``) —
        how a plan crosses the spawn boundary."""
        return ";".join(ev.spec() for ev in self.events)

    def __bool__(self) -> bool:
        return bool(self.events)

    @classmethod
    def sample(
        cls,
        jobs: Sequence[str],
        seed: int,
        crashes: int = 0,
        hangs: int = 0,
        flaky: int = 0,
        slow: int = 0,
        torn: int = 0,
        ckpt: int = 0,
        admits: int = 1,
    ) -> "FaultPlan":
        """A seeded random schedule over ``jobs``: pick victims with a
        dedicated ``random.Random(seed)`` so a chaos sweep's schedule is a
        pure function of (job list, seed)."""
        rng = random.Random(seed)
        events: list[FaultEvent] = []

        def victims(n: int) -> list[str]:
            return [rng.choice(list(jobs)) for _ in range(n)]

        for job in victims(crashes):
            events.append(FaultEvent("crash", job, attempt=0, admits=admits))
        for job in victims(hangs):
            events.append(FaultEvent("hang", job, attempt=0, admits=admits))
        for job in victims(flaky):
            events.append(FaultEvent("exc", job, attempt=1, admits=admits))
        for job in victims(slow):
            events.append(
                FaultEvent("slow", job, attempt=0, arg=rng.uniform(0.05, 0.2))
            )
        for job in victims(torn):
            events.append(FaultEvent("torn", job, attempt=0))
        for job in victims(ckpt):
            events.append(FaultEvent("ckpt", job, attempt=0))
        return cls(tuple(events))

    # ---- event selection (runtime side) -----------------------------------

    def admit_events(
        self, job: str, attempt: int, process: bool
    ) -> list[FaultEvent]:
        """The crash/hang/exc/slow events armed at this job attempt's
        admission boundaries."""
        out = []
        for ev in self.events:
            if ev.target != job:
                continue
            if ev.kind == "exc" and attempt < ev.attempt:
                out.append(ev)
            elif ev.kind in ("crash", "hang") and process and ev.attempt == attempt:
                out.append(ev)
            elif ev.kind == "slow" and ev.attempt == attempt:
                out.append(ev)
        return out

    def torn_events(self, job: str, attempt: int) -> list[FaultEvent]:
        return [
            ev
            for ev in self.events
            if ev.kind == "torn" and ev.target == job and ev.attempt == attempt
        ]

    def ckpt_events(self) -> list[FaultEvent]:
        return [ev for ev in self.events if ev.kind == "ckpt"]


def _instant(name: str, args: dict) -> None:
    tr = obs_trace.active()
    if tr is not None:
        tr.instant(name, args)


class _FaultRuntime:
    """Wrap a job's ``SearchRuntime`` so armed events fire at admission
    boundaries — the same seam the ``_SelfKillRuntime`` test hook uses, so
    a crash always lands between checkpointed batches."""

    def __init__(self, inner, events: list[FaultEvent], on_hang=None):
        self._inner = inner
        self._events = events
        self._admitted = 0
        self._on_hang = on_hang

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def admit(self, n: int) -> bool:
        for ev in self._events:
            if ev.admits == self._admitted:
                self._fire(ev)
        self._admitted += 1
        return self._inner.admit(n)

    def _fire(self, ev: FaultEvent) -> None:
        _instant("fault_injected", {"kind": ev.kind, "target": ev.target})
        if ev.kind == "slow":
            time.sleep(ev.arg)
        elif ev.kind == "exc":
            raise TransientFault(
                f"injected transient fault in {ev.target!r} "
                f"(succeeds from attempt {ev.attempt})"
            )
        elif ev.kind == "crash":
            os._exit(137)
        elif ev.kind == "hang":
            if self._on_hang is not None:
                self._on_hang()  # stop heartbeating: look dead, stay alive
            while True:  # pragma: no cover - only a parent kill ends this
                time.sleep(3600)


class _CorruptingCheckpointer:
    """Proxy a ``Checkpointer`` and flip a payload byte after the scheduled
    Nth save of a tag — the save itself stays atomic; the *content* is now
    wrong, which is exactly what the digest check must catch."""

    def __init__(self, inner, events: list[FaultEvent]):
        self._inner = inner
        self._events = events
        self._saves: dict[str, int] = {}
        self._fired: set[int] = set()

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def save(self, tag: str, state: dict):
        path = self._inner.save(tag, state)
        nth = self._saves.get(tag, 0)
        self._saves[tag] = nth + 1
        for i, ev in enumerate(self._events):
            if i in self._fired or ev.target != tag or ev.attempt != nth:
                continue
            self._fired.add(i)
            data = bytearray(path.read_bytes())
            data[len(data) // 2] ^= 0xFF
            path.write_bytes(bytes(data))
            _instant("fault_injected", {"kind": "ckpt", "target": tag})
        return path


class FaultInjector:
    """The worker/thread-side harness over a ``FaultPlan`` (module doc)."""

    def __init__(
        self,
        plan: FaultPlan,
        process: bool = True,
        on_hang: Optional[Callable[[], None]] = None,
    ):
        self.plan = plan
        self.process = process
        self._on_hang = on_hang

    def runtime(self, runtime, job: str, attempt: int):
        """``runtime`` wrapped with this attempt's admission-boundary
        events; the runtime itself when none are armed."""
        events = self.plan.admit_events(job, attempt, process=self.process)
        if not events:
            return runtime
        return _FaultRuntime(runtime, events, on_hang=self._on_hang)

    def checkpointer(self, checkpointer):
        events = self.plan.ckpt_events()
        if not events or checkpointer is None:
            return checkpointer
        return _CorruptingCheckpointer(checkpointer, events)

    def after_job(self, job: str, attempt: int, store) -> None:
        """Torn/corrupt store-line injection: one complete-but-corrupt line,
        then a newline-less fragment. If more appends follow, the fragment
        merges into the next line (a corrupt *interior* record readers must
        skip without truncating the tail); if not, it is a torn tail."""
        if store is None or not self.plan.torn_events(job, attempt):
            return
        store.flush()
        with open(store.write_path, "a", encoding="utf-8") as f:
            f.write('{"k":"zz-not-hex","w":"chaos","r":{"injected":true}}\n')
            f.write('{"k":"f00d')  # torn: no trailing newline
        _instant("fault_injected", {"kind": "torn", "target": job})
