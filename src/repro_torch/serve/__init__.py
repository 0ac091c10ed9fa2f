"""Co-design as a service: snapshot, query and admission layers.

The serve tier turns a finished (or still-running) search campaign into a
production query service (see ``docs/architecture.md`` → "Co-design as a
service"):

* ``repro_torch.serve.snapshot`` — compact a ``DurableRecordStore`` JSONL log
  into a versioned columnar frontier artifact; ``load_snapshot`` memory-maps
  it back without re-parsing JSON;
* ``repro_torch.serve.query`` — ``FrontierServer``: thread-safe, exact,
  O(log² n) ``best(scenario)`` with an LRU answer cache;
* ``repro_torch.serve.admission`` — answer ad-hoc scenarios from the frontier
  when coverage suffices, otherwise run one budgeted background search and
  fold the results back in.

Counterpart of ``repro/serve/``: copies with their imports rewritten. The
snapshot format (``MAGIC``, ``VERSION``) is the reference's, so each
implementation reads the other's artifacts; an admitted search runs on the
port's ``SearchExecutor``, its controller on ``AdmissionConfig.device``.
"""
from repro_torch.serve.admission import Admission, AdmissionConfig, AdmissionController
from repro_torch.serve.query import FrontierServer, ServeStats, brute_force_best, scenario_key
from repro_torch.serve.snapshot import (
    FrontierSnapshot,
    load_snapshot,
    load_store_frontier,
    snapshot_store,
    write_snapshot,
)

__all__ = [
    "Admission",
    "AdmissionConfig",
    "AdmissionController",
    "FrontierServer",
    "FrontierSnapshot",
    "ServeStats",
    "brute_force_best",
    "load_snapshot",
    "load_store_frontier",
    "scenario_key",
    "snapshot_store",
    "write_snapshot",
]
