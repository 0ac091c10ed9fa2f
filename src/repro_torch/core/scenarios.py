"""Named co-design use cases and the scenario registry.

The paper's third observation (Sec. 4): *different use cases lead to very
different search outcomes* — a latency-bounded datacenter SKU, an
energy-bounded battery deployment and an area-bounded edge SKU each pull the
joint (α, h) search toward a different optimum. A ``Scenario`` is a named,
frozen description of one such use case: performance/area targets plus the
constraint mode (hard p=0,q=-1 / soft p=q=-0.07, Eq. 4-6).

Counterpart of ``repro/core/scenarios.py``: ``Scenario``, the registry and
the paper's presets are copies. ``expand``, the LLM scenario grid
(``grid``) and the transfer embedding (``features``) are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

from repro_torch.core import simulator
from repro_torch.core.reward import RewardConfig, meets_constraints, reward_record

BASELINE_AREA_MM2 = simulator.BASELINE_AREA_MM2


@dataclasses.dataclass(frozen=True)
class Scenario:
    """One deployment use case: targets + constraint mode (see module doc)."""

    name: str
    description: str = ""
    latency_target_ms: Optional[float] = None
    energy_target_mj: Optional[float] = None
    area_target_mm2: float = BASELINE_AREA_MM2
    mode: str = "hard"  # "hard" (p=0,q=-1) | "soft" (p=q=-0.07)
    tags: tuple = ()
    # numeric workload axes (grid scenarios: params_b/train/seq_len/chips/
    # tier). Accepts a mapping or (key, value) pairs; canonicalized to a
    # key-sorted tuple in __post_init__ so two scenarios built from dicts
    # with different insertion orders compare (and embed) equal.
    workload: tuple = ()

    def __post_init__(self):
        if self.latency_target_ms is None and self.energy_target_mj is None:
            raise ValueError(
                f"scenario {self.name!r} needs a latency or an energy target"
            )
        if self.mode not in ("hard", "soft"):
            raise ValueError(
                f"scenario {self.name!r}: mode must be "
                f"'hard' or 'soft', got {self.mode!r}"
            )
        wl = self.workload
        items = wl.items() if isinstance(wl, Mapping) else wl
        canon = tuple(sorted((str(k), v) for k, v in items))
        object.__setattr__(self, "workload", canon)

    def workload_dict(self) -> dict:
        return dict(self.workload)

    def reward_config(self, invalid_reward: float = -1.0) -> RewardConfig:
        """The Eq. 4-6 objective for this use case. Energy-bounded scenarios
        (paper Sec. 3.4) swap the latency term for energy; the latency target
        then degenerates to +inf so only energy and area constrain.
        Re-built on demand (RewardConfig is frozen and cheap), so scenarios
        stay pure descriptions."""
        lat = self.latency_target_ms
        return RewardConfig(
            latency_target_ms=float("inf") if lat is None else lat,
            area_target_mm2=self.area_target_mm2,
            mode=self.mode,
            energy_target_mj=self.energy_target_mj,
            invalid_reward=invalid_reward,
        )

    def score(self, record: Mapping) -> float:
        """Re-score a finished metric record under this scenario's objective
        (no re-simulation — see ``reward.reward_record``)."""
        return reward_record(record, self.reward_config())

    def feasible(self, record: Mapping) -> bool:
        """Hard feasibility of a record against this scenario's targets."""
        return meets_constraints(record, self.reward_config())

    def describe(self) -> str:
        parts = []
        if self.latency_target_ms is not None:
            parts.append(f"lat≤{self.latency_target_ms:g}ms")
        if self.energy_target_mj is not None:
            parts.append(f"energy≤{self.energy_target_mj:g}mJ")
        parts.append(f"area≤{self.area_target_mm2:g}mm²")
        parts.append(self.mode)
        return " ".join(parts)


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

_REGISTRY: dict[str, Scenario] = {}


def register(scenario: Scenario, overwrite: bool = False) -> Scenario:
    if not overwrite and scenario.name in _REGISTRY:
        raise ValueError(f"scenario {scenario.name!r} already registered")
    _REGISTRY[scenario.name] = scenario
    return scenario


def get(name: str) -> Scenario:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown scenario {name!r} — known scenarios: {names()}, "
            f"presets: {sorted(PRESETS)}"
        ) from None


def names() -> list[str]:
    return sorted(_REGISTRY)


# ---------------------------------------------------------------------------
# presets (paper anchors)
# ---------------------------------------------------------------------------

# Fig. 8: the five latency targets of the latency-driven searches.
FIG8_LATENCY_TARGETS_MS = (0.3, 0.5, 0.8, 1.1, 1.3)
# Fig. 1 / Sec. 3.4: the energy-constrained variant's targets.
ENERGY_TARGETS_MJ = (0.4, 0.7, 1.0, 1.5)

for _lt in FIG8_LATENCY_TARGETS_MS:
    register(
        Scenario(
            name=f"lat-{_lt:g}ms",
            description=f"Fig. 8 latency-bounded use case, T_lat={_lt:g} ms",
            latency_target_ms=_lt,
            tags=("fig8", "latency"),
        )
    )

for _et in ENERGY_TARGETS_MJ:
    register(
        Scenario(
            name=f"energy-{_et:g}mJ",
            description=(
                f"Sec. 3.4 energy-bounded use case, T_energy={_et:g} mJ"
            ),
            energy_target_mj=_et,
            tags=("energy",),
        )
    )

# Area-bounded edge SKUs: shrink the chip budget below the 4x4-PE baseline
# (Sec. 3.3's accelerator is ~59.4 mm²) and relax latency accordingly.
for _sku, _frac, _lt in (
    ("nano", 1 / 3, 1.3),
    ("small", 1 / 2, 0.8),
    ("base", 1.0, 0.5),
):
    register(
        Scenario(
            name=f"edge-sku-{_sku}",
            description=(
                f"area-bounded edge SKU ({_frac:.0%} of baseline chip "
                f"area, T_lat={_lt:g} ms)"
            ),
            latency_target_ms=_lt,
            area_target_mm2=round(_frac * BASELINE_AREA_MM2, 1),
            tags=("edge", "area"),
        )
    )

# Soft-constraint variants (Eq. 6: p=q=-0.07) of one latency and one energy
# use case — the paper uses soft constraints when the target is aspirational.
register(
    Scenario(
        name="lat-0.5ms-soft",
        description="soft-constraint variant of lat-0.5ms",
        latency_target_ms=0.5,
        mode="soft",
        tags=("fig8", "latency", "soft"),
    )
)
register(
    Scenario(
        name="energy-0.7mJ-soft",
        description="soft-constraint variant of energy-0.7mJ",
        energy_target_mj=0.7,
        mode="soft",
        tags=("energy", "soft"),
    )
)


PRESETS: dict[str, tuple[str, ...]] = {
    "fig8-latency": tuple(f"lat-{t:g}ms" for t in FIG8_LATENCY_TARGETS_MS),
    "energy-bound": tuple(f"energy-{t:g}mJ" for t in ENERGY_TARGETS_MJ),
    "edge-skus": ("edge-sku-nano", "edge-sku-small", "edge-sku-base"),
    "constraint-modes": (
        "lat-0.5ms",
        "lat-0.5ms-soft",
        "energy-0.7mJ",
        "energy-0.7mJ-soft",
    ),
    "paper-use-cases": (
        "lat-0.3ms",
        "lat-0.8ms",
        "lat-1.3ms",
        "energy-0.7mJ",
        "edge-sku-small",
        "lat-0.5ms-soft",
    ),
}
