"""The constrained weighted-product search objective (paper Eq. 4-6):

    max  Accuracy(a,h) * (Latency(a,h)/T_lat)^w0 * (Area(h)/T_area)^w1

    w = p  if the metric meets its target, q otherwise.
    hard constraint: p=0, q=-1   soft constraint: p=q=-0.07

``reward`` scores loose metrics; ``reward_record`` / ``meets_constraints``
score a finished metric record against any ``RewardConfig`` — the raw
(α, h) → metrics map is objective-independent, so cached records can be
re-scored under a new objective (a different scenario) without touching the
simulator. The scenario sweep (``repro_torch.core.sweep``) is built on this.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Optional


@dataclasses.dataclass(frozen=True)
class RewardConfig:
    latency_target_ms: float
    area_target_mm2: float
    mode: str = "hard"  # "hard" (p=0,q=-1) | "soft" (p=q=-0.07)
    # energy-driven variant: swap latency for energy (Sec. 3.4 "can be easily
    # swapped with an energy constraint")
    energy_target_mj: Optional[float] = None
    invalid_reward: float = -1.0

    @property
    def pq(self) -> tuple[float, float]:
        return (0.0, -1.0) if self.mode == "hard" else (-0.07, -0.07)


def reward(
    accuracy: float,
    latency_ms: Optional[float],
    area_mm2: Optional[float],
    cfg: RewardConfig,
    energy_mj: Optional[float] = None,
) -> float:
    """Invalid samples (simulator returned None) get cfg.invalid_reward."""
    if latency_ms is None or area_mm2 is None:
        return cfg.invalid_reward
    p, q = cfg.pq

    if cfg.energy_target_mj is not None:
        perf_ratio = energy_mj / cfg.energy_target_mj
        perf_ok = energy_mj <= cfg.energy_target_mj
    else:
        perf_ratio = latency_ms / cfg.latency_target_ms
        perf_ok = latency_ms <= cfg.latency_target_ms
    w0 = p if perf_ok else q
    area_ratio = area_mm2 / cfg.area_target_mm2
    w1 = p if area_mm2 <= cfg.area_target_mm2 else q

    r = accuracy
    if w0 != 0.0:
        r = r * (perf_ratio ** w0)
    if w1 != 0.0:
        r = r * (area_ratio ** w1)
    return float(r)


def reward_record(record: Mapping, cfg: RewardConfig) -> float:
    """Eq. 4-6 recomputed from a finished metric record.

    ``record`` is any mapping with the engine's raw metric keys (``valid``,
    ``accuracy``, ``latency_ms``, ``energy_mj``, ``area_mm2``). Records that
    lack the metric the objective needs (e.g. predictor-backed records have no
    energy under an energy-target config) score ``cfg.invalid_reward`` — they
    cannot be certified against that objective.
    """
    if not record.get("valid", False):
        return cfg.invalid_reward
    if cfg.energy_target_mj is not None and record.get("energy_mj") is None:
        return cfg.invalid_reward
    return reward(
        record["accuracy"],
        record["latency_ms"],
        record["area_mm2"],
        cfg,
        energy_mj=record.get("energy_mj"),
    )


def meets_constraints(
    record: Mapping, cfg: RewardConfig, constraint_mode: str = "full"
) -> bool:
    """Hard-feasibility of a metric record under ``cfg``'s targets.

    Mirrors the engine's record semantics: with an energy target the energy
    metric replaces latency as the performance constraint (Sec. 3.4), and
    ``constraint_mode="area_only"`` checks chip area alone (phase-1 HAS).
    """
    if not record.get("valid", False):
        return False
    area_ok = record["area_mm2"] <= cfg.area_target_mm2
    if constraint_mode == "area_only":
        return bool(area_ok)
    if cfg.energy_target_mj is not None:
        energy = record.get("energy_mj")
        return bool(
            energy is not None and energy <= cfg.energy_target_mj and area_ok
        )
    return bool(record["latency_ms"] <= cfg.latency_target_ms and area_ok)
