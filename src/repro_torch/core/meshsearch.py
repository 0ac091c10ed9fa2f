"""NAHAS-for-pods: the paper's joint-search loop applied to the pod
"hardware configuration" — mesh factorization and distribution knobs. The
port's counterpart of ``repro/core/meshsearch.py``.

Mapping from the paper:
    accelerator config h      -> (data×model factorization, microbatches,
                                  remat policy, FSDP on/off,
                                  activation-collective style, gradient dtype)
    chip area constraint      -> chip count budget (fixed: one pod)
    latency objective         -> analytical step time (3-term roofline)
    cycle-accurate simulator  -> the analytical LM cost model
                                 (``repro_torch.hw.roofline.PodRooflineBackend``)

The analytical model is a deliberately simple Megatron-style napkin model —
it exists to RANK configurations. ``PodCostModel`` is kept as an alias for
the backend class, as in the reference.

``search_mesh`` evaluates candidates through a ``CallableEngine``
(``repro_torch.core.engine``): the pod space is small enough that a
converging PPO controller resamples configurations constantly, and the
engine's content-addressed cache serves those repeats for free. The cost
model is host arithmetic; the controller's update runs on ``device`` (the
card unless the caller asks for the CPU). Its sampling is numpy on the
host, so given equal logits the sampled configs, the records and the best
config are those of the reference.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.config import ModelConfig, ShapeConfig
from repro_torch.core.controllers import PPOController
from repro_torch.core.engine import CallableEngine
from repro_torch.core.space import Choice, Space
from repro_torch.hw.roofline import PodRooflineBackend

# compatibility alias: the pod napkin model moved behind the cost-backend
# protocol (same constructor and .evaluate surface)
PodCostModel = PodRooflineBackend


# the production default (the §Perf baseline config)
DEFAULT_REF = {"mesh": (16, 16), "microbatches": 4, "remat": "full",
               "fsdp": True, "act_collective": "allreduce",
               "grad_dtype": "float32"}


def mesh_space(chips: int = 256) -> Space:
    factorizations = []
    d = 1
    while d <= chips:
        if chips % d == 0:
            factorizations.append((d, chips // d))
        d *= 2
    choices = [
        Choice("mesh", tuple(factorizations)),  # (data, model)
        Choice("microbatches", (1, 2, 4, 8, 16)),
        Choice("remat", ("none", "dots", "full")),
        Choice("fsdp", (False, True)),
        Choice("act_collective", ("allreduce", "seqpar")),  # Megatron vs SP
        Choice("grad_dtype", ("float32", "bfloat16")),
    ]
    return Space(choices, decoder=lambda d_: d_, name="pod_mesh")


@dataclasses.dataclass
class MeshSearchResult:
    best: dict
    best_cfg: dict
    history: list


def search_mesh(
    cfg: ModelConfig,
    shape: ShapeConfig,
    samples: int = 400,
    chips: int = 256,
    seed: int = 0,
    device="cuda",
) -> MeshSearchResult:
    """PPO over ``mesh_space(chips)``, batches of 16, reward = -step ms;
    the controller's update runs on ``device``."""
    space = mesh_space(chips)
    backend = PodRooflineBackend(cfg, shape, chips=chips)
    ctrl = PPOController(space, seed=seed, device=device)

    def eval_one(vec: np.ndarray) -> dict:
        hcfg = space.to_dict(vec)
        res = backend.estimate_batch([None], [hcfg]).records[0]
        if res is None:
            return {"valid": False, "reward": -1.0, "config": hcfg}
        # minimize step time
        return dict(res, reward=-res["step_s"] * 1e3, config=hcfg)

    # the pod space is small (~10^3 points), so a converging PPO resamples
    # configs constantly — the engine cache makes those repeats free
    engine = CallableEngine(eval_one)
    history = []
    best, best_cfg = None, None
    n = 0
    while n < samples:
        vecs = ctrl.sample(min(16, samples - n))
        rewards = []
        for rec in engine.evaluate_batch(vecs):
            # engine copies are shallow; un-alias the nested config dict so
            # history entries / best_cfg stay independently mutable (the
            # legacy loop built a fresh dict per evaluation)
            rec["config"] = dict(rec["config"])
            rewards.append(rec["reward"])
            history.append(rec)
            if rec["valid"] and (best is None
                                 or rec["step_s"] < best["step_s"]):
                best = {k: v for k, v in rec.items()
                        if k not in ("config", "reward")}
                best_cfg = rec["config"]
            n += 1
        ctrl.update(vecs, np.array(rewards))
    return MeshSearchResult(best, best_cfg, history)
