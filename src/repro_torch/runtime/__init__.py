"""Durable search runtime: persistence, checkpoint/resume, concurrency.

The production layer over ``repro_torch.core``'s search stack:

* ``DurableRecordStore`` — the engine's raw-metric memo with an append-only
  JSONL log: a new process rehydrates it and starts at the prior hit rate.
  Under the sharded executor each worker process appends to its own
  single-writer segment (``<log>.worker-<k>``); the base store folds
  segments in on ``refresh()`` and merges + retires them on ``compact()``
  (``repro_torch.runtime.store``);
* ``Checkpointer`` — atomic tagged snapshots of controller + search
  progress; resume reproduces the bitwise-identical remaining trajectory
  (``repro_torch.runtime.checkpoint``);
* ``SearchRuntime`` / ``Budget`` / ``StopToken`` / ``SearchExecutor`` —
  budgeted, gracefully-stoppable concurrent execution of many searches over
  one shared store: threads by default, sharded spawn-based worker
  processes with ``processes=True`` (``repro_torch.runtime.executor``);
* ``repro_torch.runtime.cli`` — the argparse parent + runtime resolution
  of ``scripts/torch_sweep.py``.

Entry points: pass ``runtime=SearchRuntime.at(dir, store_path)`` (or just
``checkpoint_dir=``) to any ``repro_torch.core.search`` driver /
``core.session.SearchSession`` / ``sweep.SweepRunner``;
``scripts/torch_sweep.py --store/--resume [--workers N --processes]`` is the
CLI.

Counterpart of ``repro/runtime/``: copies, except that process workers pin
their cards with ``CUDA_VISIBLE_DEVICES``, report over a pipe of their own,
and checkpoints carry the implementation tag (``core.engine.IMPL``).
"""
from repro_torch.runtime.checkpoint import (
    Checkpointer,
    result_from_state,
    result_state,
)
from repro_torch.runtime.executor import (
    SELFKILL_ENV,
    Budget,
    ExecutorReport,
    JobOutcome,
    SearchExecutor,
    SearchJob,
    SearchRuntime,
    SharedBudget,
    StopToken,
    WorkerCrashed,
    WorkerError,
    scenario_jobs,
)
from repro_torch.runtime.faults import (
    FAULTS_ENV,
    FaultInjector,
    FaultPlan,
    TransientFault,
)
from repro_torch.runtime.store import DurableRecordStore

__all__ = [
    "FAULTS_ENV",
    "SELFKILL_ENV",
    "Budget",
    "Checkpointer",
    "DurableRecordStore",
    "ExecutorReport",
    "FaultInjector",
    "FaultPlan",
    "JobOutcome",
    "SearchExecutor",
    "SearchJob",
    "SearchRuntime",
    "SharedBudget",
    "StopToken",
    "TransientFault",
    "WorkerCrashed",
    "WorkerError",
    "result_from_state",
    "result_state",
    "scenario_jobs",
]
