"""Named co-design use cases and the scenario registry.

The paper's third observation (Sec. 4): *different use cases lead to very
different search outcomes* — a latency-bounded datacenter SKU, an
energy-bounded battery deployment and an area-bounded edge SKU each pull the
joint (α, h) search toward a different optimum. A ``Scenario`` is a named,
frozen description of one such use case: performance/area targets plus the
constraint mode (hard p=0,q=-1 / soft p=q=-0.07, Eq. 4-6).

``expand`` resolves any mix of ``Scenario`` objects, scenario names and
preset names into a scenario list; ``register`` adds user-defined scenarios.

Production-scale sweeps add two more pieces on top of the hand-written
presets:

* ``grid()`` — a combinatorial expander producting {LLM model config,
  train vs serve, sequence length, SKU envelope, traffic tier} into hundreds
  of registered scenarios. Each combo's latency target is derived by routing
  the workload through the pod roofline
  (``repro_torch.hw.roofline.PodRooflineBackend``) — a bigger model / longer
  sequence / smaller pod gets a proportionally looser target — then
  normalized into the edge simulator's latency regime. The workload axes
  land in ``Scenario.workload`` as plain numbers.
* ``features(scenario)`` — a fixed-length numeric embedding of the
  objective, constraint envelope, SKU bounds and workload axes, a pure
  function of the scenario's own fields; the scenario-transfer scheduler
  clusters and matches donors in this space.

Counterpart of ``repro/core/scenarios.py``, of which every piece is a copy:
the grid's scenarios and their feature vectors are equal to the
reference's.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Iterable, Mapping, Optional, Sequence, Union

import numpy as np

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


def expand(
    items: Union[str, Scenario, Iterable[Union[str, Scenario]]],
) -> list[Scenario]:
    """Resolve scenarios / scenario names / preset names (deduplicated,
    order-preserving) into a list of ``Scenario`` objects."""
    if isinstance(items, (str, Scenario)):
        items = [items]
    out: list[Scenario] = []
    seen: set[str] = set()
    for item in items:
        if isinstance(item, Scenario):
            group: Sequence[Scenario] = [item]
        elif item in PRESETS:
            group = [get(n) for n in PRESETS[item]]
        else:
            group = [get(item)]
        for s in group:
            if s.name not in seen:
                seen.add(s.name)
                out.append(s)
    if not out:
        raise ValueError("no scenarios selected")
    return out


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


# ---------------------------------------------------------------------------
# feature embedding (scenario-transfer search)
# ---------------------------------------------------------------------------

#: workload keys folded into the embedding (missing keys read as 0.0, so
#: hand-written scenarios without a workload embed on the target axes alone)
WORKLOAD_FEATURE_KEYS = ("params_b", "train", "seq_len", "chips", "tier")

#: the embedding's axes, in order (features()[i] is FEATURE_NAMES[i])
FEATURE_NAMES = (
    "has_latency",
    "log_latency",
    "has_energy",
    "log_energy",
    "log_area_frac",
    "soft",
    "wl_log_params",
    "wl_train",
    "wl_log_seq",
    "wl_log_chips",
    "wl_tier",
)


def features(scenario: Scenario) -> np.ndarray:
    """Fixed-length numeric embedding of a scenario (module doc).

    Every axis is kept O(1) (log-scaled targets, normalized workload axes)
    so no single axis dominates Euclidean distances; the vector is a pure
    function of the scenario's own fields — registration order, dict
    insertion order and the surrounding registry never enter.
    """
    wl = scenario.workload_dict()
    lat = scenario.latency_target_ms
    energy = scenario.energy_target_mj
    params_b = float(wl.get("params_b", 0.0))
    seq = float(wl.get("seq_len", 0.0))
    chips = float(wl.get("chips", 0.0))
    vec = (
        0.0 if lat is None else 1.0,
        0.0 if lat is None else math.log10(max(lat, 1e-6)),
        0.0 if energy is None else 1.0,
        0.0 if energy is None else math.log10(max(energy, 1e-6)),
        math.log10(max(scenario.area_target_mm2 / BASELINE_AREA_MM2, 1e-6)),
        1.0 if scenario.mode == "soft" else 0.0,
        math.log10(1.0 + max(params_b, 0.0)),
        float(wl.get("train", 0.0)),
        0.0 if seq <= 0 else math.log10(seq / 4096.0),
        0.0 if chips <= 0 else math.log10(chips / 64.0),
        float(wl.get("tier", 0.0)) / 2.0,
    )
    return np.asarray(vec, dtype=np.float64)


# ---------------------------------------------------------------------------
# grid expander (production-scale scenario diversity)
# ---------------------------------------------------------------------------

#: default grid axes: LLM configs (repro_torch.configs), train vs serve, sequence
#: length, SKU envelope (area fraction of the baseline accelerator + pod
#: size), and traffic tier (how aggressively the roofline step time is
#: tightened into a latency target)
GRID_MODELS = (
    "gemma_2b",
    "qwen3_1_7b",
    "granite_3_2b",
    "mamba2_370m",
    "mistral_nemo_12b",
    "qwen2_moe_a2_7b",
)
GRID_MODES = ("train", "serve")
GRID_SEQ_LENS = (4096, 16384, 32768)
#: sku -> (area fraction of BASELINE_AREA_MM2, pod chips for the roofline)
GRID_SKUS = {"nano": (1 / 3, 64), "small": (1 / 2, 128), "base": (1.0, 256)}
#: tier -> (tier index, fraction of the roofline step time kept as target)
GRID_TIERS = {"low": (0, 2.0), "mid": (1, 1.0), "high": (2, 0.5)}
#: the edge simulator's realistic latency regime the roofline-derived
#: targets are clipped into (the paper's Fig. 8 targets span 0.3-1.3 ms)
GRID_LATENCY_CLIP_MS = (0.2, 2.0)


@functools.lru_cache(maxsize=None)
def _pod_step_ms(model: str, mode: str, seq_len: int, chips: int) -> float:
    """Reference pod step time (ms) for one workload combo, via
    ``PodRooflineBackend`` on a fixed canonical mesh. Deterministic per
    combo (never a function of the rest of the grid); imports are deferred
    so the registry stays importable without torch. Tries a microbatch ladder
    (deeper splits fit tighter HBM), then falls back to the compute-only
    roofline term when no reference config fits."""
    from repro_torch import configs
    from repro_torch.config import ShapeConfig
    from repro_torch.hw.roofline import PodRooflineBackend

    cfg = configs.get(model)
    global_batch = 256 if mode == "train" else 128
    shape = ShapeConfig(
        f"grid-{mode}-{seq_len}",
        seq_len,
        global_batch,
        "train" if mode == "train" else "decode",
    )
    backend = PodRooflineBackend(cfg, shape, chips=chips)
    mesh = (max(chips // 16, 1), min(chips, 16))
    base = {
        "mesh": mesh,
        "remat": "full",
        "fsdp": True,
        "act_collective": "seqpar",
        "grad_dtype": "bfloat16",
    }
    for k in (4, 8, 16, 32):
        rec = backend.evaluate({**base, "microbatches": k})
        if rec is not None:
            return float(rec["latency_ms"])
    # nothing fits the reference meshes: compute-bound lower bound
    _total, active = backend._param_count()
    mult = 8.0 if shape.mode == "train" else 2.0
    tokens = shape.global_batch * shape.seq_len
    eff_tokens = tokens if shape.mode != "decode" else shape.global_batch
    step_s = mult * active * eff_tokens / chips / backend.chip.peak_bf16_flops
    return float(step_s * 1e3)


def grid(
    models: Sequence[str] = GRID_MODELS,
    modes: Sequence[str] = GRID_MODES,
    seq_lens: Sequence[int] = GRID_SEQ_LENS,
    skus: Optional[Mapping[str, tuple]] = None,
    tiers: Optional[Mapping[str, tuple]] = None,
    limit: Optional[int] = None,
    register_scenarios: bool = True,
) -> list[Scenario]:
    """Product the grid axes into registered scenarios (module doc).

    Deterministic: the combo order is the nested product order of the axis
    arguments, names encode the combo, and each latency target depends only
    on its own combo's roofline step time — so ``grid(limit=300)`` always
    yields the same 300 scenarios. Re-running overwrites prior
    registrations of the same names (idempotent)."""
    skus = GRID_SKUS if skus is None else skus
    tiers = GRID_TIERS if tiers is None else tiers
    lo, hi = GRID_LATENCY_CLIP_MS
    out: list[Scenario] = []
    for model in models:
        for mode in modes:
            if mode not in ("train", "serve"):
                raise ValueError(f"grid mode must be 'train' or 'serve', got {mode!r}")
            for seq in seq_lens:
                for sku, (area_frac, chips) in skus.items():
                    step_ms = _pod_step_ms(model, mode, int(seq), int(chips))
                    params_b = _model_params_b(model)
                    for tier, (tier_idx, frac) in tiers.items():
                        if limit is not None and len(out) >= limit:
                            return out
                        target = min(max(step_ms / 1e3 * frac, lo), hi)
                        sc = Scenario(
                            name=(
                                f"grid-{model}-{mode}-s{int(seq) // 1024}k-"
                                f"{sku}-{tier}"
                            ),
                            description=(
                                f"{model} {mode} seq={seq} on {sku} SKU "
                                f"({chips} chips), {tier} tier — roofline "
                                f"step {step_ms:.0f} ms"
                            ),
                            latency_target_ms=round(target, 4),
                            area_target_mm2=round(area_frac * BASELINE_AREA_MM2, 1),
                            tags=("grid", model, mode, sku, tier),
                            workload={
                                "params_b": params_b,
                                "train": 1.0 if mode == "train" else 0.0,
                                "seq_len": float(seq),
                                "chips": float(chips),
                                "tier": float(tier_idx),
                            },
                        )
                        if register_scenarios:
                            register(sc, overwrite=True)
                        out.append(sc)
    return out


@functools.lru_cache(maxsize=None)
def _model_params_b(model: str) -> float:
    """Total parameter count (billions) of a named LLM config."""
    from repro_torch import configs
    from repro_torch.launch.roofline import count_params

    return float(count_params(configs.get(model))["total"] / 1e9)


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
