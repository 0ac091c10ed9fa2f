"""SearchSession — one entrypoint owning engine/backend/runtime resolution.

The four search drivers (``repro_torch.core.search``) accumulated the same kwarg
sprawl: each took ``engine=/predictor=/backend=/runtime=/checkpoint_dir=``
and re-implemented the same mutual-exclusion checks and engine construction.
``SearchSession`` hoists that resolution into one object constructed once:

    from repro_torch.core import nas, proxy
    from repro_torch.core.session import SearchSession

    session = SearchSession(nas.tiny_space(), proxy.SurrogateAccuracy(),
                            cfg=SearchConfig(samples=256),
                            checkpoint_dir="/tmp/ck")
    res = session.joint(scenario=scenarios.get("lat-0.3ms"))
    res = session.fixed_hw(scenario=scenarios.get("edge-sku-nano"))

Resolution rules (applied once, in ``__init__``):

* ``engine=`` is mutually exclusive with ``backend=``/``predictor=`` — a
  prebuilt engine already fixes its backend;
* ``predictor=`` is the deprecated PR-4 shim (warns ``DeprecationWarning``):
  pass ``backend=repro_torch.hw.LearnedBackend(...)`` instead;
* ``runtime=`` (any ``repro_torch.runtime.SearchRuntime``-shaped object) wins over
  the ``checkpoint_dir=`` shorthand; both resolve here, not per call;
* the engines each method builds memoize into ``cfg.store`` when set, else
  the runtime's shared (possibly durable) store.

The legacy module-level drivers (``joint_search`` & co) remain as thin
wrappers over a per-call session, so every existing signature keeps working;
new code should construct a session. Methods are per-search: each call
builds (or reuses) its engine and drives one search; a session can run many
searches against one runtime/store, which is exactly the sweep pattern.

Port note: a copy of ``repro/core/session.py``. The controller's device is
``cfg.device`` and the accuracy signal's its own (``TrainedAccuracy.device``).
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Callable, Optional

import numpy as np

from repro_torch.core import has as has_lib
from repro_torch.core import search as search_lib
from repro_torch.core.engine import EvaluationEngine
from repro_torch.core.reward import RewardConfig
from repro_torch.core.scenarios import Scenario
from repro_torch.core.search import SearchConfig, SearchResult
from repro_torch.core.space import Space, concat
from repro_torch.obs import metrics as obs_metrics


class SearchSession:
    """Engine/backend/runtime resolution done once; drivers as methods
    (module doc)."""

    def __init__(
        self,
        nas_space: Space,
        acc_fn: Optional[Callable] = None,
        cfg: Optional[SearchConfig] = None,
        *,
        has_space: Optional[Space] = None,
        engine: Optional[EvaluationEngine] = None,
        backend=None,
        predictor=None,
        runtime=None,
        checkpoint_dir: Optional[str] = None,
    ):
        if predictor is not None:
            warnings.warn(
                "predictor= is deprecated: pass backend="
                "repro_torch.hw.LearnedBackend(model, nas_space, has_space) "
                "(or a prebuilt engine=) instead",
                DeprecationWarning,
                stacklevel=2,
            )
        if engine is not None and (predictor is not None or backend is not None):
            raise ValueError(
                "pass either engine= or predictor=/backend=, not "
                "both — a prebuilt engine already fixes its backend"
            )
        self.nas_space = nas_space
        self.acc_fn = acc_fn
        self.cfg = cfg or SearchConfig()
        self.has_space = has_space or has_lib.has_space()
        self.engine = engine
        self.backend = backend
        self.predictor = predictor
        self.runtime = search_lib._as_runtime(runtime, checkpoint_dir)

    # ---- resolution helpers ------------------------------------------------

    def _cfg(self, cfg: Optional[SearchConfig]) -> SearchConfig:
        return cfg if cfg is not None else self.cfg

    def _store(self, cfg: SearchConfig):
        return search_lib._runtime_store(cfg, self.runtime)

    def _label(self, scenario: Optional[Scenario]) -> Optional[str]:
        return None if scenario is None else scenario.name

    def _require_no_engine(self, driver: str) -> None:
        if self.engine is not None:
            raise ValueError(
                f"{driver} search builds one engine per phase and cannot run "
                f"a prebuilt engine=; pass backend= instead"
            )

    # ---- drivers -----------------------------------------------------------

    def search(self, driver: str = "joint", **kw) -> SearchResult:
        """Dispatch by driver name (the CLI/sweep entry):
        joint | fixed_hw | phase | nested."""
        fns = {"joint": self.joint, "fixed_hw": self.fixed_hw,
               "phase": self.phase, "nested": self.nested}
        if driver not in fns:
            raise ValueError(f"unknown driver {driver!r} (one of {sorted(fns)})")
        return fns[driver](**kw)

    def joint(
        self,
        rcfg: Optional[RewardConfig] = None,
        scenario: Optional[Scenario] = None,
        cfg: Optional[SearchConfig] = None,
        tag: str = "joint",
        transfer: Optional[search_lib.TransferSpec] = None,
    ) -> SearchResult:
        """NAHAS multi-trial: one controller over the unified (NAS ++ HAS)
        space (paper Sec. 3.5). ``transfer=`` warm-starts a fresh search
        from a solved neighbor's checkpoint (``search.TransferSpec``)."""
        cfg = self._cfg(cfg)
        rcfg = search_lib._objective(rcfg, scenario)
        joint = concat(self.nas_space, self.has_space)
        engine = self.engine
        if engine is None:
            engine = EvaluationEngine(
                self.nas_space,
                self.has_space,
                self.acc_fn,
                rcfg,
                proxy_batch=cfg.proxy_batch,
                cache=cfg.cache,
                predictor=self.predictor,
                backend=self.backend,
                store=self._store(cfg),
                label=self._label(scenario),
            )
        warm = None
        if cfg.hot_start and cfg.controller in ("ppo", "reinforce"):
            base = has_lib.baseline_vec(self.has_space)
            warm = (self.nas_space.num_decisions, base, cfg.hot_start_logit)
        return search_lib._drive(
            joint, engine, cfg, warm_has=warm, scenario=scenario,
            runtime=self.runtime, tag=tag, transfer=transfer,
        )

    def fixed_hw(
        self,
        rcfg: Optional[RewardConfig] = None,
        scenario: Optional[Scenario] = None,
        h=None,
        cfg: Optional[SearchConfig] = None,
        tag: str = "fixed_hw",
        transfer: Optional[search_lib.TransferSpec] = None,
    ) -> SearchResult:
        """Platform-aware NAS baseline: HAS frozen (default: the baseline
        accelerator)."""
        cfg = self._cfg(cfg)
        rcfg = search_lib._objective(rcfg, scenario)
        h = h or has_lib.BASELINE
        engine = self.engine
        if engine is None:
            engine = EvaluationEngine(
                self.nas_space,
                None,
                self.acc_fn,
                rcfg,
                fixed_h=h,
                backend=self.backend,
                proxy_batch=cfg.proxy_batch,
                cache=cfg.cache,
                store=self._store(cfg),
                label=self._label(scenario),
            )
        return search_lib._drive(
            self.nas_space, engine, cfg, scenario=scenario,
            runtime=self.runtime, tag=tag, transfer=transfer,
        )

    def phase(
        self,
        rcfg: Optional[RewardConfig] = None,
        scenario: Optional[Scenario] = None,
        initial_arch_vec: Optional[np.ndarray] = None,
        cfg: Optional[SearchConfig] = None,
        tag: str = "phase",
    ) -> SearchResult:
        """Fig. 9: phase 1 = HAS on a fixed initial architecture (soft
        constraint), phase 2 = NAS on the selected accelerator (hard
        constraint). The sample budget is split between the phases. With a
        runtime checkpointer, each phase checkpoints under its own sub-tag; a
        completed phase replays from its checkpoint on resume instead of
        re-searching."""
        self._require_no_engine("phase")
        cfg = self._cfg(cfg)
        rcfg = search_lib._objective(rcfg, scenario)
        hspace = self.has_space
        rng = np.random.default_rng(cfg.seed)
        a0 = (
            initial_arch_vec
            if initial_arch_vec is not None
            else self.nas_space.sample(rng)
        )
        spec0 = self.nas_space.decode(a0)
        soft = dataclasses.replace(rcfg, mode="soft")
        acc0 = self.acc_fn(spec0)

        h_engine = EvaluationEngine(
            None,
            hspace,
            None,
            soft,
            fixed_spec=spec0,
            fixed_acc=acc0,
            constraint_mode="area_only",
            proxy_batch=cfg.proxy_batch,
            cache=cfg.cache,
            backend=self.backend,
            store=self._store(cfg),
            label=self._label(scenario),
        )
        half = dataclasses.replace(cfg, samples=cfg.samples // 2)
        phase1 = search_lib._drive(
            hspace, h_engine, half, scenario=scenario,
            runtime=self.runtime, tag=f"{tag}.has",
        )
        h_best = (
            hspace.decode(phase1.best_vec)
            if phase1.best_vec is not None
            else has_lib.BASELINE
        )
        phase2 = self.fixed_hw(
            rcfg,
            scenario=scenario,
            h=h_best,
            cfg=dataclasses.replace(cfg, samples=cfg.samples - half.samples),
            tag=f"{tag}.nas",
        )
        history = phase1.history + phase2.history
        return SearchResult(
            phase2.best_vec,
            phase2.best_record,
            history,
            self.nas_space,
            phase1.wall_s + phase2.wall_s,
            {"phase1": phase1.engine_stats, "phase2": phase2.engine_stats},
        )

    def nested(
        self,
        rcfg: Optional[RewardConfig] = None,
        scenario: Optional[Scenario] = None,
        outer: int = 8,
        cfg: Optional[SearchConfig] = None,
        tag: str = "nested",
    ) -> SearchResult:
        """Outer loop over hardware samples; a small NAS per hardware config.
        Each inner NAS checkpoints under its own sub-tag; the outer hardware
        draws are deterministic from the seed, so resume replays completed
        inners from their checkpoints and re-derives the h sequence for
        free."""
        self._require_no_engine("nested")
        cfg = self._cfg(cfg)
        rcfg = search_lib._objective(rcfg, scenario)
        hspace = self.has_space
        rng = np.random.default_rng(cfg.seed)
        inner_budget = max(cfg.samples // outer, 4)
        history = []
        best, best_vec = None, None
        import time as _time

        t0 = _time.monotonic()
        inner_stats: list[dict] = []
        for o in range(outer):
            hv = hspace.sample(rng)
            h = hspace.decode(hv)
            res = self.fixed_hw(
                rcfg,
                scenario=scenario,
                h=h,
                cfg=dataclasses.replace(cfg, samples=inner_budget, seed=cfg.seed + o),
                tag=f"{tag}.outer{o}",
            )
            history.extend(res.history)
            inner_stats.append(res.engine_stats)
            if res.best_record is not None and (
                best is None or res.best_record["reward"] > best["reward"]
            ):
                best, best_vec = res.best_record, res.best_vec
        # fold the per-inner engine stats through the one shared merge:
        # counters sum, every *_rate is recomputed from the summed counters
        # (never summed/averaged), and non-numeric keys survive
        stats = obs_metrics.merge_stats(inner_stats)
        return SearchResult(
            best_vec, best, history, self.nas_space,
            _time.monotonic() - t0, stats,
        )
