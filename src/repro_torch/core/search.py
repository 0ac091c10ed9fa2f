"""Search drivers (paper Sec. 3.5, 4.4, 4.5).

* ``joint_search``      — NAHAS multi-trial: one controller over the unified
                          (NAS ++ HAS) space.
* ``fixed_hw_search``   — platform-aware NAS baseline: HAS frozen (default:
                          the baseline accelerator).
* ``phase_search``      — HAS-then-NAS (Fig. 9 baseline): phase 1 searches the
                          accelerator for a fixed initial architecture with the
                          SOFT constraint; phase 2 runs NAS on the chosen
                          accelerator with the HARD constraint.
* ``nested_search``     — outer HAS loop, small inner NAS per hardware sample.

All four drivers evaluate candidates through a
``repro_torch.core.engine.EvaluationEngine``: each controller batch is decoded and
simulated in one vectorized pass (``simulator.simulate_batch``) and finished
records are memoized content-addressed on the encoded (α, h) vector, so
repeated samples — common under PPO late in search — cost nothing. Pass
``backend=`` to substitute a hardware cost backend from ``repro_torch.hw``
(analytic / learned / cascade, or any ``CostBackend``), or ``engine=`` for
a fully custom engine; see ``docs/architecture.md``.

Every driver returns a ``SearchResult`` whose ``history`` carries one record
per evaluated sample (accuracy, latency, energy, area, reward, validity, the
encoded decision vector, and — when searching for a scenario — the scenario
name) — the benchmarks build Figs. 1/7/8/9 and Table 3 from these, and any
record drops straight into a ``repro_torch.core.pareto.ParetoFrontier``
(``SearchResult.frontier()``). ``engine_stats`` carries the evaluation-cache
counters for the run.

Drivers accept the objective either as an explicit ``RewardConfig`` or as a
named ``Scenario`` (``scenario=``, see ``repro_torch.core.scenarios``); passing
``SearchConfig(store=RecordStore())`` shares one raw-metric memo across every
engine the driver builds — and across drivers/scenarios, which is how the
scenario sweep (``repro_torch.core.sweep``) amortizes evaluation.

Port note: a copy of ``repro/core/search.py`` with device plumbing
(``SearchConfig.device``, passed to the PPO / REINFORCE controller). Every
checkpoint ``_drive`` writes carries ``meta["impl"] = engine.IMPL``, and a
resume refuses a checkpoint of the other implementation (or one without the
tag, as the reference writes them); the description below is the
reference's.

Durability: every driver also accepts ``runtime=`` (any object with the
``repro_torch.runtime.SearchRuntime`` surface: ``store``, ``checkpoint``,
``admit(n)``, ``checkpoint_every``) or the ``checkpoint_dir=`` shorthand.
With a checkpointer attached, ``_drive`` persists controller state, history
and progress at every batch boundary; re-running the same driver call with
the same ``tag`` resumes mid-search and reproduces the *bitwise-identical*
remaining trajectory (controllers snapshot their RNG + optimizer state — see
``controllers``; the snapshot carries the sampler's trajectory version, and
resuming a checkpoint written by the retired v1 per-draw sampler fails with
a clear error instead of silently diverging). A completed search's
checkpoint doubles as a result cache:
re-running it replays the finished ``SearchResult`` without evaluating
anything. When the runtime's budget/stop-token denies the next batch,
drivers checkpoint and raise ``SearchInterrupted``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np

from repro_torch.core.controllers import CONTROLLERS
from repro_torch.core.engine import IMPL, EvaluationEngine, RecordStore
from repro_torch.core.pareto import DEFAULT_OBJECTIVES, ParetoFrontier
from repro_torch.core.reward import RewardConfig
from repro_torch.core.scenarios import Scenario
from repro_torch.core.space import Space
from repro_torch.obs import trace as obs_trace


@dataclasses.dataclass
class SearchConfig:
    samples: int = 500
    batch: int = 16  # samples per controller update
    controller: str = "ppo"
    seed: int = 0
    proxy_batch: int = 1  # inference batch for the simulator
    cache: bool = True  # engine memoization of repeated samples
    # hot-start the HAS decision logits at the baseline accelerator ("co-search
    # with hot start", Jiang et al. 2020a — cited in the paper's related work):
    # at small sample budgets the controller then explores AROUND a known-good
    # design instead of uniformly over the (mostly invalid) joint space
    hot_start: bool = True
    hot_start_logit: float = 1.5
    # share one raw-metric memo across every engine this config builds (and
    # across runs reusing the same store) — see engine.RecordStore
    store: Optional[RecordStore] = None
    # where the PPO / REINFORCE controller keeps its logits and runs its
    # update ("cuda" or "cpu"); the evolution controller is numpy throughout
    device: str = "cuda"


@dataclasses.dataclass(frozen=True)
class TransferSpec:
    """Scenario-transfer warm start for one search (ROADMAP item 5).

    ``donor`` names the solved scenario whose converged controller state
    seeds this search (recorded as ``transferred_from`` provenance when the
    adoption succeeds). The donor state arrives either in-memory
    (``state=``: a full checkpoint state dict or a bare
    ``controller.state()`` snapshot) or — the scheduler's path — by
    ``donor_tag``, loaded through the runtime's ``Checkpointer`` (which is
    exactly the log-shipping layout process workers already share).

    Transfer is strictly best-effort: version or space incompatibility, a
    missing donor checkpoint, or a controller without ``transfer_from``
    all fall back to the ordinary cold start (provenance stays ``None``).
    A search resuming from its *own* checkpoint ignores the spec entirely —
    resume semantics stay bitwise-identical."""

    donor: str
    donor_tag: Optional[str] = None
    state: Optional[dict] = None


class SearchInterrupted(RuntimeError):
    """A search stopped at a batch boundary before exhausting its sample
    budget (runtime budget spent, deadline passed, or graceful stop). When a
    checkpointer is attached the in-flight state was saved under ``tag``
    first, so re-running the same driver call resumes exactly."""

    def __init__(self, tag: str, samples_done: int, samples: int):
        super().__init__(
            f"search {tag!r} interrupted at {samples_done}/{samples} samples"
        )
        self.tag = tag
        self.samples_done = samples_done
        self.samples = samples


@dataclasses.dataclass
class SearchResult:
    best_vec: Optional[np.ndarray]
    best_record: Optional[dict]
    history: list
    space: Space
    wall_s: float
    engine_stats: Optional[dict] = None
    # scenario-transfer provenance: the donor scenario's name when this
    # search warm-started from another search's checkpoint, else None
    transferred_from: Optional[str] = None

    def pareto(self, x_key="latency_ms", y_key="accuracy") -> list[dict]:
        pts = [h for h in self.history if h.get("valid")]
        pts.sort(key=lambda h: h[x_key])
        out, best_y = [], -np.inf
        for p in pts:
            if p[y_key] > best_y:
                out.append(p)
                best_y = p[y_key]
        return out

    def frontier(self, objectives=DEFAULT_OBJECTIVES) -> ParetoFrontier:
        """The run's history folded into an incremental Pareto frontier over
        (accuracy, latency, energy, area) — see ``repro_torch.core.pareto``."""
        f = ParetoFrontier(objectives)
        f.add_many(self.history)
        return f


def _objective(rcfg: Optional[RewardConfig],
               scenario: Optional[Scenario]) -> RewardConfig:
    """An explicit RewardConfig wins; otherwise the scenario supplies it."""
    if rcfg is not None:
        return rcfg
    if scenario is None:
        raise ValueError("pass a RewardConfig (rcfg=) or a Scenario "
                         "(scenario=)")
    return scenario.reward_config()


def _as_runtime(runtime, checkpoint_dir):
    """Resolve the ``runtime=``/``checkpoint_dir=`` driver arguments (an
    explicit runtime wins; the shorthand builds a checkpoint-only one)."""
    if runtime is not None or checkpoint_dir is None:
        return runtime
    from repro_torch.runtime import SearchRuntime  # deferred: core stays standalone

    return SearchRuntime.at(checkpoint_dir)


def _runtime_store(cfg: SearchConfig, runtime) -> Optional[RecordStore]:
    """The store engines should memoize into: an explicit ``cfg.store`` wins
    over the runtime's shared (possibly durable) store."""
    if cfg.store is not None or runtime is None:
        return cfg.store
    return getattr(runtime, "store", None)


def _apply_transfer(ctrl, transfer: TransferSpec, cfg: SearchConfig,
                    space, ck, tag: str) -> Optional[str]:
    """Best-effort warm start of ``ctrl`` from the transfer spec's donor
    (see ``TransferSpec``). Returns the donor name when the state was
    adopted, ``None`` on any cold fallback. Emits ``donor_load`` /
    ``transfer_init`` trace spans so reports can attribute warm vs cold
    setup time per scenario."""
    tr = obs_trace.active()
    donor_state = transfer.state
    if donor_state is None and transfer.donor_tag is not None and ck is not None:
        t0 = tr.now() if tr is not None else 0.0
        donor_state = ck.load(transfer.donor_tag)
        if tr is not None:
            tr.complete("donor_load", t0, {
                "tag": tag, "donor": transfer.donor,
                "found": donor_state is not None,
            })
    t0 = tr.now() if tr is not None else 0.0
    applied = False
    reason = None
    if donor_state is None:
        reason = "no donor state"
    else:
        meta = donor_state.get("meta") or {}
        # a full checkpoint state nests the controller snapshot; a bare
        # controller.state() dict IS the snapshot
        ctrl_state = donor_state.get("controller", donor_state)
        if meta and meta.get("impl") != IMPL:
            reason = f"donor implementation {meta.get('impl')!r}"
        elif meta and meta.get("controller") != cfg.controller:
            reason = f"donor controller {meta.get('controller')!r}"
        elif meta and meta.get("space") != space.name:
            reason = f"donor space {meta.get('space')!r}"
        elif not hasattr(ctrl, "transfer_from"):
            reason = f"{type(ctrl).__name__} does not transfer"
        else:
            try:
                ctrl.transfer_from(ctrl_state)
                applied = True
            except (KeyError, ValueError) as e:
                reason = str(e)
    if tr is not None:
        args = {"tag": tag, "donor": transfer.donor, "applied": applied}
        if reason is not None:
            args["fallback"] = reason
        tr.complete("transfer_init", t0, args)
    return transfer.donor if applied else None


def _drive(space, engine: EvaluationEngine, cfg: SearchConfig,
           warm_has=None, scenario: Optional[Scenario] = None,
           runtime=None, tag: str = "search",
           transfer: Optional[TransferSpec] = None) -> SearchResult:
    on_device = {"device": cfg.device} if cfg.controller in ("ppo", "reinforce") else {}
    ctrl = CONTROLLERS[cfg.controller](space, seed=cfg.seed, **on_device)
    if warm_has is not None and hasattr(ctrl, "warm_start"):
        ctrl.warm_start(*warm_has)
    history = []
    best = None
    best_vec = None
    n = 0
    wall_base = 0.0
    transferred_from: Optional[str] = None
    resumed = False
    ck = getattr(runtime, "checkpoint", None) if runtime is not None else None
    every = max(int(getattr(runtime, "checkpoint_every", 1) or 1), 1)
    replay = False
    if ck is not None:
        state = ck.load(tag)
        if state is not None:
            resumed = True
            meta = state["meta"]
            if meta.get("impl") != IMPL:
                raise ValueError(
                    f"checkpoint {tag!r} was written by implementation "
                    f"{meta.get('impl') or 'repro (untagged)'!r}, not "
                    f"{IMPL!r}; refusing to resume"
                )
            want = {"space": space.name, "controller": cfg.controller,
                    "seed": cfg.seed, "samples": cfg.samples,
                    "batch": cfg.batch,
                    "scenario": None if scenario is None else scenario.name}
            got = {k: meta.get(k) for k in want}
            if got != want:
                raise ValueError(
                    f"checkpoint {tag!r} was written by a different search "
                    f"({got} != {want}); refusing to resume"
                )
            history = list(state["history"])
            n = state["samples_done"]
            best = state["best_record"]
            best_vec = (None if state["best_vec"] is None
                        else np.asarray(state["best_vec"]))
            wall_base = state.get("wall_s", 0.0)
            # resumed searches keep the provenance their first run recorded
            transferred_from = state.get("transferred_from")
            # a COMPLETED checkpoint is a pure result cache: the controller
            # state is never consulted again, so skip restoring it — which
            # also lets finished searches from older sampler generations
            # (trajectory v1) keep replaying, while a mid-search v1
            # checkpoint is rejected by load_state below
            replay = n >= cfg.samples
            if not replay:
                ctrl.load_state(state["controller"])
    if transfer is not None and not resumed:
        # warm start only a FRESH search: a resume already has its own
        # trajectory (transferring on top would diverge it)
        transferred_from = _apply_transfer(ctrl, transfer, cfg, space, ck, tag)
    t0 = time.monotonic()

    def save():
        state = {
            "meta": {"impl": IMPL,
                     "space": space.name, "controller": cfg.controller,
                     "seed": cfg.seed, "samples": cfg.samples,
                     "batch": cfg.batch,
                     "scenario": None if scenario is None else scenario.name},
            "controller": ctrl.state(),
            "samples_done": n,
            "history": history,
            "best_record": best,
            "best_vec": None if best_vec is None else np.asarray(best_vec),
            "wall_s": wall_base + time.monotonic() - t0,
        }
        # provenance only when warm: cold-path checkpoints stay
        # bitwise-identical to builds without the transfer layer
        if transferred_from is not None:
            state["transferred_from"] = transferred_from
        ck.save(tag, state)

    batches = 0
    # one span per driven search; try/finally so an interrupted (budget) or
    # crashed search still records the interval it actually ran
    tr = obs_trace.active()
    t_span = tr.now() if tr is not None else 0.0
    try:
        while n < cfg.samples:
            batch = min(cfg.batch, cfg.samples - n)
            if runtime is not None and not runtime.admit(batch):
                if ck is not None:
                    save()
                raise SearchInterrupted(tag, n, cfg.samples)
            vecs = ctrl.sample(batch)
            recs = engine.evaluate_batch(vecs)
            rewards = []
            for v, rec in zip(vecs, recs):
                rec["sample_idx"] = n
                # frontier-ready annotations: enough identity to reconstruct
                # the full (α, h) config from any record — the sampled
                # decision vector plus its space name (HAS- and NAS-space
                # index tuples would otherwise alias in one frontier), the
                # frozen accelerator for nas-mode engines, and the scenario
                # that paid for the evaluation
                rec["vec"] = tuple(int(x) for x in v)
                rec["space"] = space.name
                if engine.mode == "nas":
                    rec["fixed_h"] = dataclasses.astuple(engine.fixed_h)
                elif engine.mode == "has":
                    rec["fixed_spec_id"] = engine.fixed_spec_id
                if scenario is not None:
                    rec["scenario"] = scenario.name
                history.append(rec)
                rewards.append(rec["reward"])
                if rec["valid"] and rec.get("meets_constraints") and (
                    best is None or rec["reward"] > best["reward"]
                ):
                    best, best_vec = rec, np.asarray(v)
                n += 1
            ctrl.update(vecs, np.array(rewards))
            batches += 1
            if ck is not None and batches % every == 0:
                save()
    finally:
        if tr is not None:
            span_args = {"tag": tag, "samples": n,
                         "scenario": None if scenario is None else scenario.name}
            if transferred_from is not None:
                span_args["transferred_from"] = transferred_from
            tr.complete("search", t_span, span_args)
    if ck is not None and not replay:
        save()  # final state: doubles as the completed-search result cache
    # fall back to best-by-reward if nothing met the constraints
    if best is None:
        valid = [
            (h, i) for i, h in enumerate(history) if h["valid"]
        ]
        if valid:
            best = max(valid, key=lambda t: t[0]["reward"])[0]
    return SearchResult(best_vec, best, history, space,
                        wall_base + time.monotonic() - t0,
                        engine.stats.as_dict(),
                        transferred_from=transferred_from)


# ---------------------------------------------------------------------------
# Legacy driver entrypoints. These are thin wrappers over
# ``repro_torch.core.session.SearchSession``, which owns engine/backend/runtime
# resolution (and the deprecation of the ``predictor=`` shim) in one place;
# the signatures below are kept verbatim for compatibility. New code should
# construct a ``SearchSession``.
# ---------------------------------------------------------------------------


def _session(nas_space, acc_fn, has_space=None, engine=None, predictor=None,
             backend=None, runtime=None, checkpoint_dir=None):
    from repro_torch.core.session import SearchSession  # deferred: session imports us

    return SearchSession(
        nas_space, acc_fn,
        has_space=has_space, engine=engine, predictor=predictor,
        backend=backend, runtime=runtime, checkpoint_dir=checkpoint_dir,
    )


def joint_search(
    nas_space: Space,
    acc_fn: Callable,
    rcfg: Optional[RewardConfig] = None,
    cfg: SearchConfig = SearchConfig(),
    has_space: Optional[Space] = None,
    engine: Optional[EvaluationEngine] = None,
    predictor=None,
    backend=None,
    scenario: Optional[Scenario] = None,
    runtime=None,
    checkpoint_dir: Optional[str] = None,
    tag: str = "joint",
    transfer: Optional[TransferSpec] = None,
) -> SearchResult:
    return _session(
        nas_space, acc_fn, has_space=has_space, engine=engine,
        predictor=predictor, backend=backend, runtime=runtime,
        checkpoint_dir=checkpoint_dir,
    ).joint(rcfg=rcfg, scenario=scenario, cfg=cfg, tag=tag, transfer=transfer)


def fixed_hw_search(
    nas_space: Space,
    acc_fn: Callable,
    rcfg: Optional[RewardConfig] = None,
    cfg: SearchConfig = SearchConfig(),
    h=None,
    engine: Optional[EvaluationEngine] = None,
    backend=None,
    scenario: Optional[Scenario] = None,
    runtime=None,
    checkpoint_dir: Optional[str] = None,
    tag: str = "fixed_hw",
    transfer: Optional[TransferSpec] = None,
) -> SearchResult:
    return _session(
        nas_space, acc_fn, engine=engine, backend=backend,
        runtime=runtime, checkpoint_dir=checkpoint_dir,
    ).fixed_hw(rcfg=rcfg, scenario=scenario, h=h, cfg=cfg, tag=tag,
               transfer=transfer)


def phase_search(
    nas_space: Space,
    acc_fn: Callable,
    rcfg: Optional[RewardConfig] = None,
    cfg: SearchConfig = SearchConfig(),
    initial_arch_vec: Optional[np.ndarray] = None,
    backend=None,
    scenario: Optional[Scenario] = None,
    runtime=None,
    checkpoint_dir: Optional[str] = None,
    tag: str = "phase",
) -> SearchResult:
    """Fig. 9: phase 1 = HAS on a fixed initial architecture (soft constraint),
    phase 2 = NAS on the selected accelerator (hard constraint). See
    ``SearchSession.phase``."""
    return _session(
        nas_space, acc_fn, backend=backend,
        runtime=runtime, checkpoint_dir=checkpoint_dir,
    ).phase(rcfg=rcfg, scenario=scenario, initial_arch_vec=initial_arch_vec,
            cfg=cfg, tag=tag)


def nested_search(
    nas_space: Space,
    acc_fn: Callable,
    rcfg: Optional[RewardConfig] = None,
    cfg: SearchConfig = SearchConfig(),
    outer: int = 8,
    backend=None,
    scenario: Optional[Scenario] = None,
    runtime=None,
    checkpoint_dir: Optional[str] = None,
    tag: str = "nested",
) -> SearchResult:
    """Outer loop over hardware samples; a small NAS per hardware config.
    See ``SearchSession.nested``."""
    return _session(
        nas_space, acc_fn, backend=backend,
        runtime=runtime, checkpoint_dir=checkpoint_dir,
    ).nested(rcfg=rcfg, scenario=scenario, outer=outer, cfg=cfg, tag=tag)
