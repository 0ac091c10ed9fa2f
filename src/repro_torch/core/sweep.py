"""Multi-use-case Pareto co-design sweeps over one shared evaluation memo.

The paper's observation that "different use cases lead to very different
search outcomes" turns, in production, into a fleet question: given N
deployment scenarios (latency-, energy- and area-bounded SKUs, hard and soft
constraint modes), find each one's best (α, h) pair without paying N full
evaluation bills. The raw (α, h) → metrics map is objective-independent, so
the sweep runs every scenario's search through **one** ``RecordStore``
(`repro_torch.core.engine`): any candidate a scenario re-visits — or that *another*
scenario already paid for — is served from memory and merely re-scored under
the new objective (Eq. 4-6 from the record, no simulation). On top, every
record is folded into one global Pareto frontier over (accuracy, latency,
energy, area); per-scenario winners are read off the frontier with
per-scenario constraint filtering, so scenario B can select a configuration
scenario A discovered (the semi-decoupled pattern of Lu et al. 2022).

    from repro_torch.core import nas, proxy, sweep

    result = sweep.SweepRunner(
        "paper-use-cases", nas.tiny_space(), proxy.SurrogateAccuracy(),
        sweep.SweepConfig(search=search.SearchConfig(samples=200)),
    ).run()
    print(result.table())

``scripts/torch_sweep.py`` is the CLI.

The sweep rides the vectorized search hot path end to end (trajectory v2:
batched controller sampling + fused updates, one ``CachedAccuracy.batch``
pass per engine batch, columnar engine loop) — a quick 6-scenario sweep is
simulator-bound rather than Python-dispatch-bound.

Grid-scale sweeps (``scenarios.grid()``: hundreds of scenarios) add
``SweepConfig(transfer=True)``: ``plan_transfer`` picks ~sqrt(N)
feature-space medoids to run cold at the full budget, every other scenario
warm-starts from its nearest medoid's converged controller state
(``search.TransferSpec``) at ``transfer_budget()`` samples. Winners are
selected off the global frontier either way, so the schedule changes no
per-scenario best configs.

Counterpart of ``repro/core/sweep.py``: a copy. ``devices_per_worker``
pins each process worker to its own cards with ``CUDA_VISIBLE_DEVICES``
(``repro_torch.runtime.executor``); ``run_concurrent`` calls the accuracy
signal's ``prepare`` (``TrainedAccuracy`` builds its kernel) before a
process pool spawns, and reports each worker's ready time
(``SweepResult.ready_s``).
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Optional

import numpy as np

from repro_torch.core import has as has_lib
from repro_torch.core import scenarios as scenarios_lib
from repro_torch.core import search as search_lib
from repro_torch.core.engine import RecordStore
from repro_torch.core.pareto import DEFAULT_OBJECTIVES, ParetoFrontier
from repro_torch.core.proxy import CachedAccuracy
from repro_torch.core.scenarios import Scenario
from repro_torch.core.search import SearchConfig, SearchResult
from repro_torch.core.space import Space
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace

DRIVERS = {
    "joint": search_lib.joint_search,
    "fixed_hw": search_lib.fixed_hw_search,
    "phase": search_lib.phase_search,
    "nested": search_lib.nested_search,
}


@dataclasses.dataclass
class SweepConfig:
    driver: str = "joint"  # joint | fixed_hw | phase | nested
    search: SearchConfig = dataclasses.field(default_factory=SearchConfig)
    # one raw-metric memo across all scenarios (False = per-scenario engines
    # with private caches — an ablation)
    share_cache: bool = True
    objectives: tuple = DEFAULT_OBJECTIVES
    # hardware cost backend shared by every scenario's engine (repro_torch.hw:
    # analytic when None, or a LearnedBackend / CascadeBackend instance —
    # sharing one instance is what aligns the store namespaces and, for the
    # cascade, pools the dominance incumbents across scenarios)
    backend: Optional[object] = None
    # shorthand for a checkpoint-only runtime: per-scenario searches then
    # checkpoint every batch and the sweep resumes mid-scenario (see
    # repro_torch.runtime; an explicit runtime passed to run() wins)
    checkpoint_dir: Optional[str] = None
    # concurrent execution (repro_torch.runtime.SearchExecutor): workers > 0 fans
    # the scenarios over N threads — or, with processes=True, shards them
    # across N spawned worker processes with single-writer log-shipping
    # store segments (needs a durable store, or no store for private
    # worker caches). devices_per_worker gives each worker that many cards
    # of its own (CUDA_VISIBLE_DEVICES; None: every worker sees every card).
    workers: int = 0
    processes: bool = False
    devices_per_worker: Optional[int] = None
    # self-healing knobs (repro_torch.runtime.executor): a failed/crashed scenario
    # job is retried (with backoff, resuming from its checkpoint) up to
    # max_job_retries times before quarantine; job_deadline_s kills a job
    # running longer than this (measured from its start ack) so hung workers
    # cannot stall the wave. Fault injection (REPRO_FAULTS) rides on top.
    max_job_retries: int = 3
    job_deadline_s: Optional[float] = None
    # process mode: hold workers at a barrier until all are imported+ready
    # and report the setup time as ExecutorReport.spawn_s
    sync_start: bool = False
    # scenario-transfer scheduling (plan_transfer): feature-space cluster
    # medoids run first, cold, at the full budget; every other scenario then
    # warm-starts from its nearest medoid's checkpoint at the reduced
    # transfer budget. joint/fixed_hw drivers only.
    transfer: bool = False
    # samples for warm (transferred) searches; None = samples // 4, floored
    # at one controller batch
    transfer_samples: Optional[int] = None
    # cold medoid count; None = ceil(sqrt(num_scenarios))
    transfer_medoids: Optional[int] = None

    def transfer_budget(self) -> int:
        if self.transfer_samples is not None:
            return self.transfer_samples
        return max(self.search.batch, self.search.samples // 4)


@dataclasses.dataclass
class ScenarioOutcome:
    """One scenario's slice of a sweep."""

    scenario: Scenario
    result: SearchResult
    best: Optional[dict]  # frontier-selected best (≥ the run's own best)

    @property
    def feasible(self) -> bool:
        """Whether the selected best meets the scenario's hard constraints —
        False flags a best-effort fallback pick (nothing on the frontier was
        feasible, e.g. an over-tight hard target or a soft-mode scenario)."""
        return self.best is not None and self.scenario.feasible(self.best)

    def as_dict(self) -> dict:
        return {
            "scenario": self.scenario.name,
            "targets": self.scenario.describe(),
            "best": self.best,
            "feasible": self.feasible,
            "samples": len(self.result.history),
            "wall_s": self.result.wall_s,
            "engine_stats": self.result.engine_stats,
            "transferred_from": self.result.transferred_from,
        }


@dataclasses.dataclass
class SweepResult:
    outcomes: list[ScenarioOutcome]
    frontier: ParetoFrontier
    store_stats: Optional[dict]  # None when share_cache=False
    wall_s: float
    # process-mode extra (sync_start): one-time worker spin-up wall clock,
    # reported once per pool even when transfer runs multiple waves over it
    spawn_s: Optional[float] = None
    # self-healing counters summed across waves (ExecutorReport.recovery):
    # retries / respawns / deadline_kills / heartbeat_kills / crashes /
    # quarantined. None on the serial path.
    recovery: Optional[dict] = None
    # process mode: each worker's seconds from spawn to ready, one entry per
    # incarnation (ExecutorReport.ready_s). None on the serial path.
    ready_s: Optional[dict] = None

    @property
    def cross_scenario_hit_rate(self) -> float:
        """Recomputed from the folded counters via the shared rate helper
        (process-mode store_stats are merged across worker segments, so the
        counters — not a pre-baked rate — are the source of truth)."""
        if not self.store_stats:
            return 0.0
        return obs_metrics.rate(
            self.store_stats.get("cross_hits", 0),
            self.store_stats.get("gets", 0),
        )

    def best_by_scenario(self) -> dict[str, Optional[dict]]:
        return {o.scenario.name: o.best for o in self.outcomes}

    def table(self) -> str:
        """Per-scenario best-config table + shared-cache counters."""
        hdr = (
            f"{'scenario':<18} {'targets':<34} {'acc%':>6} {'lat_ms':>8} "
            f"{'mJ':>7} {'mm2':>7} {'feas':>5}  config"
        )
        lines = [hdr, "-" * len(hdr)]
        for o in self.outcomes:
            b = o.best
            if b is None:
                lines.append(
                    f"{o.scenario.name:<18} "
                    f"{o.scenario.describe():<34} (no valid record)"
                )
                continue
            energy = b.get("energy_mj")
            e_str = "   None" if energy is None else f"{energy:>7.4f}"
            lines.append(
                f"{o.scenario.name:<18} {o.scenario.describe():<34} "
                f"{b['accuracy'] * 100:>6.2f} {b['latency_ms']:>8.4f} "
                f"{e_str} {b['area_mm2']:>7.1f} "
                f"{str(o.feasible):>5}  "
                f"vec={b.get('vec')}"
            )
        lines.append("")
        lines.append(
            f"pareto frontier: {len(self.frontier)} points from "
            f"{self.frontier.offered} records"
        )
        if self.store_stats:
            s = self.store_stats
            lines.append(
                f"shared store: {s['puts']} evaluations for {s['gets']} "
                f"lookups — hit rate {s['hit_rate']:.1%}, cross-scenario "
                f"hit rate {s['cross_hit_rate']:.1%}"
            )
        return "\n".join(lines)

    def as_dict(self) -> dict:
        return {
            "outcomes": [o.as_dict() for o in self.outcomes],
            "frontier": self.frontier.records(),
            "store_stats": self.store_stats,
            "cross_scenario_hit_rate": self.cross_scenario_hit_rate,
            "wall_s": self.wall_s,
            "spawn_s": self.spawn_s,
            "recovery": self.recovery,
        }


@dataclasses.dataclass(frozen=True)
class TransferPlan:
    """Cold-first schedule over a scenario set: ``medoids`` (selection
    order) run cold at the full budget; every other scenario warm-starts
    from ``donors[name]``, its nearest medoid in feature space."""

    medoids: tuple
    donors: dict  # warm scenario name -> donor medoid name


def plan_transfer(scenarios, k: Optional[int] = None) -> TransferPlan:
    """Greedy farthest-point k-medoids over ``scenarios.features`` vectors
    (k defaults to ceil(sqrt(n))): the first medoid is the most central
    scenario, each next one the scenario farthest from every chosen medoid —
    so the cold runs span the feature space and every warm scenario has a
    nearby donor. Fully deterministic: features are pure functions of
    scenario fields, and every arg-min/-max tie resolves to the lowest index
    (first occurrence), independent of registration or dict order."""
    scenarios = scenarios_lib.expand(scenarios)
    n = len(scenarios)
    if k is None:
        k = max(1, math.ceil(math.sqrt(n)))
    k = max(1, min(k, n))
    with obs_trace.span("transfer_schedule", scenarios=n, medoids=k):
        feats = np.stack([scenarios_lib.features(sc) for sc in scenarios])
        dist = np.linalg.norm(feats[:, None, :] - feats[None, :, :], axis=-1)
        chosen = [int(np.argmin(dist.sum(axis=1)))]
        while len(chosen) < k:
            nearest = dist[:, chosen].min(axis=1)
            nearest[chosen] = -1.0  # never re-pick a medoid
            chosen.append(int(np.argmax(nearest)))
        donors = {}
        for i, sc in enumerate(scenarios):
            if i in chosen:
                continue
            j = chosen[int(np.argmin(dist[i, chosen]))]
            donors[sc.name] = scenarios[j].name
    return TransferPlan(
        medoids=tuple(scenarios[i].name for i in chosen), donors=donors
    )


def _transfer_runtime(runtime):
    """Transfer ships donor controller state through a ``Checkpointer``
    (serial and process workers alike — the log-shipping layout). When the
    caller's runtime has none, attach an ephemeral one; the returned cleanup
    callable (else ``None``) removes it. The ephemeral checkpointer exists
    only to carry donor state, not for durability, so periodic saves are
    disabled (each search fsyncs once, at completion) — a caller-provided
    checkpointer keeps its own cadence."""
    if runtime is not None and getattr(runtime, "checkpoint", None) is not None:
        return runtime, None
    import shutil
    import tempfile

    from repro_torch.runtime import Checkpointer, SearchRuntime  # deferred import

    tmp = tempfile.mkdtemp(prefix="repro-transfer-ck-")
    ck = Checkpointer(tmp)
    no_periodic = 1 << 30
    if runtime is None:
        rt = SearchRuntime(checkpoint=ck, checkpoint_every=no_periodic)
    else:
        rt = SearchRuntime(
            store=getattr(runtime, "store", None),
            checkpoint=ck,
            budget=getattr(runtime, "budget", None),
            stop=getattr(runtime, "stop", None),
            checkpoint_every=no_periodic,
        )
    return rt, (lambda: shutil.rmtree(tmp, ignore_errors=True))


def assemble_result(
    results: list[tuple[Scenario, SearchResult]],
    objectives=DEFAULT_OBJECTIVES,
    store_stats: Optional[dict] = None,
    wall_s: float = 0.0,
) -> SweepResult:
    """Fold (scenario, SearchResult) pairs into a ``SweepResult``: one global
    frontier over every history record, winners selected per scenario off the
    frontier. Shared by the serial ``SweepRunner`` and the concurrent
    ``repro_torch.runtime.SearchExecutor`` CLI path (both produce the same report,
    and for identical seeds the same records)."""
    frontier = ParetoFrontier(objectives)
    for _, res in results:
        frontier.add_many(res.history)
    # select winners off the *global* frontier: a scenario may pick a config
    # some other scenario's search discovered (reward and feasibility are
    # monotone in the four metrics, so the frontier always contains an
    # optimal record for every scenario)
    outcomes = [ScenarioOutcome(sc, res, frontier.best(sc)) for sc, res in results]
    return SweepResult(
        outcomes=outcomes,
        frontier=frontier,
        store_stats=store_stats,
        wall_s=wall_s,
    )


class SweepRunner:
    """Fan N scenarios over one search driver and one shared evaluation memo.

    ``scenarios`` accepts anything ``scenarios.expand`` does: preset names
    ("paper-use-cases"), scenario names, ``Scenario`` objects, or a mix.
    Every scenario runs the same driver at the same sample budget and seed —
    identical seeds are deliberate: scenario searches then start from the same
    controller state and diverge only where their objectives pull them apart,
    which both isolates the use-case effect (the paper's comparison) and
    maximizes cross-scenario cache sharing early in the runs.
    """

    def __init__(
        self,
        scenarios,
        nas_space: Space,
        acc_fn: Callable,
        cfg: Optional[SweepConfig] = None,
        has_space: Optional[Space] = None,
    ):
        self.scenarios = scenarios_lib.expand(scenarios)
        self.nas_space = nas_space
        self.cfg = cfg or SweepConfig()
        if self.cfg.driver not in DRIVERS:
            raise ValueError(
                f"unknown driver {self.cfg.driver!r} "
                f"(one of {sorted(DRIVERS)})"
            )
        if self.cfg.transfer and self.cfg.driver not in ("joint", "fixed_hw"):
            raise ValueError(
                f"transfer warm-starts a single controller and only the "
                f"joint/fixed_hw drivers have one, not {self.cfg.driver!r}"
            )
        if has_space is not None and self.cfg.driver != "joint":
            # fixed_hw/phase/nested build their own accelerator side and
            # would silently ignore a custom space
            raise ValueError(
                f"has_space is only honored by the 'joint' driver, "
                f"not {self.cfg.driver!r}"
            )
        self.has_space = has_space or has_lib.has_space()
        # one memoized accuracy signal for the whole sweep: engines built for
        # different scenarios then share architecture evaluations too, and
        # identical acc_fn identity keeps their store namespaces aligned
        if not isinstance(acc_fn, CachedAccuracy):
            acc_fn = CachedAccuracy(acc_fn)
        self.acc_fn = acc_fn

    def run(self, verbose: bool = False, runtime=None) -> SweepResult:
        """Run every scenario's search. ``runtime`` (or
        ``cfg.checkpoint_dir``) attaches a search runtime: a shared —
        possibly durable — store, per-scenario checkpointing (tag
        ``sweep.<scenario>``), and a budget/stop token. A re-run with the
        same runtime resumes: completed scenarios replay from their
        checkpoints, the interrupted one continues mid-search, and a run
        whose budget expires raises ``search.SearchInterrupted`` after
        checkpointing. With ``cfg.workers > 0`` the scenarios run
        concurrently (``run_concurrent``)."""
        cfg = self.cfg
        runtime = search_lib._as_runtime(runtime, cfg.checkpoint_dir)
        if cfg.workers > 0:
            return self.run_concurrent(verbose=verbose, runtime=runtime)
        # honor a caller-provided store (cross-run / cross-sweep reuse), then
        # the runtime's shared store; otherwise build one per run when
        # sharing is on
        store = cfg.search.store
        if store is None and runtime is not None:
            store = getattr(runtime, "store", None)
        if store is None and cfg.share_cache:
            store = RecordStore()
        driver = DRIVERS[cfg.driver]
        scfg = dataclasses.replace(cfg.search, store=store)
        t0 = time.monotonic()
        order = list(self.scenarios)
        specs: dict[str, search_lib.TransferSpec] = {}
        warm_cfg = scfg
        warm_runtime = runtime
        cleanup = None
        plan = None
        if cfg.transfer and len(self.scenarios) > 1:
            caller_runtime = runtime
            runtime, cleanup = _transfer_runtime(runtime)
            plan = plan_transfer(self.scenarios, k=cfg.transfer_medoids)
            by_name = {sc.name: sc for sc in self.scenarios}
            # medoids first (cold, full budget) so every warm scenario's
            # donor checkpoint exists by the time it runs
            order = [by_name[m] for m in plan.medoids] + [
                sc for sc in self.scenarios if sc.name in plan.donors
            ]
            specs = {
                name: search_lib.TransferSpec(donor=donor, donor_tag=f"sweep.{donor}")
                for name, donor in plan.donors.items()
            }
            warm_cfg = dataclasses.replace(scfg, samples=cfg.transfer_budget())
            # the ephemeral checkpointer exists only so medoids can donate:
            # warm searches then take the donor state inline and run under
            # the caller's own runtime — zero checkpoint writes on the warm
            # fan-out (a caller-provided checkpointer keeps full durability)
            warm_runtime = runtime if cleanup is None else caller_runtime
            if verbose:
                print(
                    f"[sweep] transfer: {len(plan.medoids)} medoids cold "
                    f"({scfg.samples} samples), {len(plan.donors)} warm "
                    f"({warm_cfg.samples} samples)",
                    flush=True,
                )
        try:
            by_result: dict[str, SearchResult] = {}
            donor_states: dict[str, dict] = {}
            for sc in order:
                spec = specs.get(sc.name)
                run_cfg = scfg if spec is None else warm_cfg
                run_runtime = runtime if spec is None else warm_runtime
                if spec is not None and cleanup is not None:
                    # inline the donor state (loaded once per medoid) so the
                    # warm search never touches the ephemeral checkpointer
                    if spec.donor not in donor_states:
                        donor_states[spec.donor] = runtime.checkpoint.load(
                            spec.donor_tag
                        )
                    spec = search_lib.TransferSpec(
                        donor=spec.donor, state=donor_states[spec.donor]
                    )
                if verbose:
                    warm = "" if spec is None else f" <- {spec.donor}"
                    print(
                        f"[sweep] {sc.name}: {sc.describe()} "
                        f"({cfg.driver}, {run_cfg.samples} samples){warm}",
                        flush=True,
                    )
                kw = dict(
                    cfg=run_cfg,
                    backend=cfg.backend,
                    scenario=sc,
                    runtime=run_runtime,
                    tag=f"sweep.{sc.name}",
                )
                if spec is not None:
                    kw["transfer"] = spec
                if cfg.driver == "joint":
                    res = driver(
                        self.nas_space, self.acc_fn, has_space=self.has_space, **kw
                    )
                else:
                    res = driver(self.nas_space, self.acc_fn, **kw)
                by_result[sc.name] = res
        finally:
            if cleanup is not None:
                cleanup()
        results: list[tuple[Scenario, SearchResult]] = [
            (sc, by_result[sc.name]) for sc in self.scenarios
        ]
        return assemble_result(
            results,
            objectives=cfg.objectives,
            store_stats=None if store is None else store.stats.as_dict(),
            wall_s=time.monotonic() - t0,
        )

    def run_concurrent(self, verbose: bool = False, runtime=None) -> SweepResult:
        """The same sweep through ``repro_torch.runtime.SearchExecutor``:
        ``cfg.workers`` threads, or that many sharded worker processes with
        ``cfg.processes`` (single-writer log-shipping store segments, merged
        back on return). Identical seeds per scenario make the per-scenario
        histories bitwise-equal to a serial ``run()``. Raises the first
        per-scenario error, or ``search.SearchInterrupted`` when any search
        stopped on the budget/deadline (in-flight state checkpointed first
        when the runtime has a checkpointer)."""
        from repro_torch.runtime import SearchExecutor, scenario_jobs

        cfg = self.cfg
        runtime = search_lib._as_runtime(runtime, cfg.checkpoint_dir)
        do_transfer = cfg.transfer and len(self.scenarios) > 1
        store = cfg.search.store
        if store is None and runtime is not None:
            store = getattr(runtime, "store", None)
        if store is None and cfg.share_cache and not cfg.processes:
            # match the serial path: one shared in-memory memo — threads
            # only; process workers without a durable store run private
            # caches (values are identical either way, sharing only skips
            # re-simulation)
            store = RecordStore()
        cleanup = None
        if do_transfer:
            runtime, cleanup = _transfer_runtime(runtime)
        prepare = getattr(self.acc_fn.fn, "prepare", None)
        if cfg.processes and callable(prepare):
            prepare()  # build the kernels once, before any worker spawns
        ex = SearchExecutor(
            store=store,
            checkpoint=None if runtime is None else runtime.checkpoint,
            max_workers=cfg.workers,
            budget=None if runtime is None else runtime.budget,
            checkpoint_every=1 if runtime is None else runtime.checkpoint_every,
            objectives=cfg.objectives,
            processes=cfg.processes,
            devices_per_worker=cfg.devices_per_worker,
            sync_start=cfg.sync_start,
            max_job_retries=cfg.max_job_retries,
            job_deadline_s=cfg.job_deadline_s,
            # transfer runs two waves (cold medoids, then the warm fan-out)
            # against one spawned fleet: warm donor checkpoints ship through
            # the shared Checkpointer, not a worker respawn
            persistent=do_transfer and cfg.processes,
        )

        def check(report) -> None:
            for name, err in report.errors.items():
                raise RuntimeError(f"search {name} failed") from err
            interrupted = report.interrupted
            if interrupted:
                err = report.outcomes[interrupted[0]].error
                if isinstance(err, search_lib.SearchInterrupted):
                    raise err
                raise search_lib.SearchInterrupted(
                    interrupted[0], 0, cfg.search.samples
                ) from err

        t0 = time.monotonic()
        # the executor's runtime carries the store; jobs must not also pin it
        # (an in-memory store inside job kwargs would not survive pickling)
        base_cfg = dataclasses.replace(cfg.search, store=None)
        mode = "processes" if cfg.processes else "threads"
        try:
            if do_transfer:
                plan = plan_transfer(self.scenarios, k=cfg.transfer_medoids)
                medoid_set = set(plan.medoids)
                cold = [sc for sc in self.scenarios if sc.name in medoid_set]
                warm = [sc for sc in self.scenarios if sc.name not in medoid_set]
                specs = {
                    sc.name: search_lib.TransferSpec(
                        donor=plan.donors[sc.name],
                        donor_tag=f"sweep.{plan.donors[sc.name]}",
                    )
                    for sc in warm
                }
                warm_cfg = dataclasses.replace(base_cfg, samples=cfg.transfer_budget())
                if verbose:
                    print(
                        f"[sweep] transfer: {len(cold)} medoids cold "
                        f"({base_cfg.samples} samples) then {len(warm)} warm "
                        f"({warm_cfg.samples} samples) on {cfg.workers} "
                        f"{mode}",
                        flush=True,
                    )
                jobs = scenario_jobs(
                    cold,
                    self.nas_space,
                    self.acc_fn,
                    base_cfg,
                    driver=cfg.driver,
                    backend=cfg.backend,
                )
                report = ex.run(jobs)
                check(report)
                outcomes = dict(report.outcomes)
                spawn_s = report.spawn_s
                store_stats = report.store_stats
                recovery = report.recovery
                ready_s = report.ready_s
                if warm:
                    jobs = scenario_jobs(
                        warm,
                        self.nas_space,
                        self.acc_fn,
                        warm_cfg,
                        driver=cfg.driver,
                        backend=cfg.backend,
                        transfer_specs=specs,
                    )
                    report = ex.run(jobs)
                    check(report)
                    outcomes.update(report.outcomes)
                    # cumulative counters: the warm wave's snapshot already
                    # folds the cold wave's work (same pool, same segments)
                    store_stats = report.store_stats
                    ready_s = report.ready_s or ready_s  # the same pool, cumulative
                    if report.recovery is not None:
                        recovery = {
                            k: (recovery or {}).get(k, 0) + v
                            for k, v in report.recovery.items()
                        }
            else:
                jobs = scenario_jobs(
                    self.scenarios,
                    self.nas_space,
                    self.acc_fn,
                    base_cfg,
                    driver=cfg.driver,
                    backend=cfg.backend,
                )
                if verbose:
                    print(
                        f"[sweep] {len(jobs)} scenarios on {cfg.workers} "
                        f"{mode} ({cfg.driver}, {cfg.search.samples} samples "
                        f"each)",
                        flush=True,
                    )
                report = ex.run(jobs)
                check(report)
                outcomes = dict(report.outcomes)
                spawn_s = report.spawn_s
                store_stats = report.store_stats
                recovery = report.recovery
                ready_s = report.ready_s
        finally:
            ex.close()
            if cleanup is not None:
                cleanup()
        results = [(sc, outcomes[f"sweep.{sc.name}"].result) for sc in self.scenarios]
        out = assemble_result(
            results,
            objectives=cfg.objectives,
            store_stats=store_stats,
            wall_s=time.monotonic() - t0,
        )
        out.spawn_s = spawn_s
        out.recovery = recovery
        out.ready_s = ready_s
        return out


def run_sweep(
    scenarios,
    nas_space: Space,
    acc_fn: Callable,
    cfg: Optional[SweepConfig] = None,
    **kw,
) -> SweepResult:
    """Functional convenience wrapper around ``SweepRunner``."""
    return SweepRunner(scenarios, nas_space, acc_fn, cfg, **kw).run()
