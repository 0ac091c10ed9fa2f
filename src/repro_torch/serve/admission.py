"""Ad-hoc scenario admission: serve from the frontier, or search on demand.

The paper's multi-use-case economics (Sec. 4.5) say most questions a
deployed co-design service gets — "best (α, h) under 0.45 ms and 40 mm²?" —
are answerable from records *other* scenarios already paid for: the global
Pareto frontier contains a best record for every monotone scalarization.
``AdmissionController`` turns that into a policy:

* **covered** — the frontier's best record for the scenario meets its hard
  constraints (``scenario.feasible``): answer immediately from the
  ``FrontierServer``, zero simulator cost;
* **uncovered** — nothing on the frontier is feasible (the query falls
  outside the explored envelope): enqueue one *budgeted* background search
  (``Budget(max_samples=cfg.budget_samples)``) through the existing
  ``SearchExecutor``/``scenario_jobs`` machinery, then ``fold`` the search's
  frontier back into the live server — the next identical (or nearby) query
  is covered.

Admissions are deduplicated on the canonicalized scenario (targets + mode):
concurrent queries for the same envelope share one search, and a scenario
searched *successfully* once is never searched again in this controller's
lifetime (the fold made whatever is achievable available; if it is still
infeasible, the envelope is simply not reachable and the best-effort answer
stands). A *failed* search — a transient worker error, a dying store — does
not poison the scenario: the in-flight slot is released, the failure is
counted (``failed``), and the next query for the envelope retries, up to
``AdmissionConfig.max_attempts`` failures before the scenario is marked
exhausted.

Searches run on a private thread pool so ``query`` returns immediately with
the current best-effort answer plus the admission status; ``wait`` blocks
until the background work folds in (tests and the CLI's one-shot mode use
it). An optional shared ``DurableRecordStore`` makes admission searches
land in the same durable memo the offline sweeps use.

Counterpart of ``repro/serve/admission.py``: a copy over the port's
``SearchExecutor``, whose ``AdmissionConfig`` gains ``device`` (the card by
default): where an admitted search's PPO / REINFORCE controller runs. An
accuracy signal that trains on the card (``TrainedAccuracy``) should be
``prepare()``-d before the first query, so that no pool thread builds its
kernel while another waits on it.
"""
from __future__ import annotations

import dataclasses
import threading
from concurrent.futures import Future, ThreadPoolExecutor, wait as _fwait
from typing import Callable, Optional

from repro_torch.core.search import SearchConfig
from repro_torch.obs import trace as obs_trace
from repro_torch.runtime.executor import Budget, SearchExecutor, scenario_jobs
from repro_torch.serve.query import FrontierServer, scenario_key


@dataclasses.dataclass(frozen=True)
class AdmissionConfig:
    """Knobs for the background-search path (module doc)."""

    budget_samples: int = 96   # evaluation tokens per admitted search
    batch: int = 16            # controller batch size
    seed: int = 0
    driver: str = "joint"      # any repro_torch.core.sweep driver
    controller: str = "reinforce"
    max_concurrent: int = 2    # background searches in flight at once
    max_attempts: int = 3      # failed searches tolerated before "exhausted"
    device: str = "cuda"       # where the PPO / REINFORCE controller runs

    def search_config(self) -> SearchConfig:
        # search samples == budget tokens, so admitted searches finish inside
        # their budget instead of reporting interrupted
        return SearchConfig(
            samples=self.budget_samples,
            batch=self.batch,
            seed=self.seed,
            controller=self.controller,
            device=self.device,
        )


@dataclasses.dataclass
class Admission:
    """One ``query`` outcome: the answer now, and how it was (or will be)
    produced. ``status`` is ``"served"`` (covered by the frontier),
    ``"searching"`` (a background search was enqueued or is in flight) or
    ``"exhausted"`` (already searched; best-effort answer is final)."""

    scenario: object
    status: str
    answer: dict
    future: Optional[Future] = None

    @property
    def served(self) -> bool:
        return self.status == "served"

    def result(self, timeout: Optional[float] = None) -> dict:
        """Block for the background search (if any), then re-answer."""
        if self.future is not None:
            self.future.result(timeout=timeout)
        return self.answer


class AdmissionController:
    """Coverage-or-search admission over one ``FrontierServer`` (module doc).

    ``nas_space`` / ``acc_fn`` / ``backend`` are the same objects the
    offline sweeps take; admission searches are ordinary ``SearchJob``s and
    share the durable memo when ``store`` is given.
    """

    def __init__(
        self,
        server: FrontierServer,
        nas_space,
        acc_fn: Callable,
        cfg: AdmissionConfig = AdmissionConfig(),
        store=None,
        backend=None,
    ):
        self.server = server
        self.nas_space = nas_space
        self.acc_fn = acc_fn
        self.cfg = cfg
        self.store = store
        self.backend = backend
        self._lock = threading.Lock()
        self._inflight: dict[tuple, Future] = {}
        self._searched: set[tuple] = set()
        self._failures: dict[tuple, int] = {}  # failed attempts per scenario
        self._pool = ThreadPoolExecutor(
            max_workers=cfg.max_concurrent,
            thread_name_prefix="admission",
        )
        self.admitted = 0  # background searches actually launched
        self.failed = 0    # launched searches that raised (slot released)

    # ---- policy ------------------------------------------------------------

    def covered(self, scenario) -> bool:
        """True when the live frontier already answers ``scenario`` within
        its hard envelope."""
        best = self.server.best(scenario)
        return best is not None and scenario.feasible(best)

    def query(self, scenario, wait: bool = False) -> Admission:
        """Answer ``scenario`` from the frontier; admit a budgeted search
        when the envelope is uncovered. With ``wait=True`` the call blocks
        until any admitted search has folded in and the answer is final."""
        with obs_trace.span(
            "admission_query", scenario=getattr(scenario, "name", None)
        ) as sp:
            answer = self.server.answer(scenario)
            if answer["feasible"]:
                sp.set(status="served")
                return Admission(scenario, "served", answer)
            key = scenario_key(scenario)
            with self._lock:
                fut = self._inflight.get(key)
                if fut is None:
                    if key in self._searched:
                        sp.set(status="exhausted")
                        return Admission(scenario, "exhausted", answer)
                    fut = self._pool.submit(self._search_and_fold, scenario, key)
                    self._inflight[key] = fut
                    self.admitted += 1
            sp.set(status="searching")
            adm = Admission(scenario, "searching", answer, future=fut)
            if wait:
                try:
                    fut.result()
                except Exception:  # noqa: BLE001 - failed search: slot was
                    # released in _search_and_fold; the next query retries
                    # (or sees "exhausted") — the best-effort answer stands
                    with self._lock:
                        if key in self._searched:
                            adm.status = "exhausted"
                adm.answer = self.server.answer(scenario)
            return adm

    # ---- background search ---------------------------------------------------

    def _search_and_fold(self, scenario, key: tuple) -> int:
        """Run one admitted search. Success retires the scenario for good
        (``_searched``); a raised search only releases the in-flight slot and
        counts the failure, so the next query retries — until
        ``cfg.max_attempts`` failures exhaust the scenario."""
        ok = False
        try:
            with obs_trace.span(
                "admission_search", scenario=getattr(scenario, "name", None)
            ):
                folded = self._run_search(scenario)
            ok = True
            return folded
        finally:
            with self._lock:
                self._inflight.pop(key, None)
                if ok:
                    self._searched.add(key)
                    self._failures.pop(key, None)
                else:
                    self.failed += 1
                    n = self._failures[key] = self._failures.get(key, 0) + 1
                    if n >= self.cfg.max_attempts:
                        self._searched.add(key)
                    tr = obs_trace.active()
                    if tr is not None:
                        tr.instant(
                            "admission_search_failed",
                            {
                                "scenario": getattr(scenario, "name", None),
                                "attempt": n,
                                "exhausted": key in self._searched,
                            },
                        )

    def _run_search(self, scenario) -> int:
        jobs = scenario_jobs(
            [scenario],
            self.nas_space,
            self.acc_fn,
            cfg=self.cfg.search_config(),
            driver=self.cfg.driver,
            backend=self.backend,
        )
        executor = SearchExecutor(
            store=self.store,
            max_workers=1,
            budget=Budget(max_samples=self.cfg.budget_samples),
            # no inner job retries: admission already retries at query
            # granularity (``max_attempts``); nesting would multiply attempts
            max_job_retries=0,
        )
        report = executor.run(jobs)
        for outcome in report.outcomes.values():
            if outcome.status == "error":
                raise outcome.error
        return self.server.fold(report.frontier.records())

    # ---- lifecycle -----------------------------------------------------------

    def wait(self, timeout: Optional[float] = None) -> None:
        """Block until every in-flight admission search has folded in."""
        with self._lock:
            futs = list(self._inflight.values())
        _fwait(futs, timeout=timeout)

    def close(self) -> None:
        self.wait()
        self._pool.shutdown(wait=True)

    def __enter__(self) -> "AdmissionController":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
