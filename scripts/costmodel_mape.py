"""Validation errors of the learned cost model as the oneshot search uses it,
at ``chip_smoke.py``'s costmodel settings (its ``COST_POINTS`` and
``COST_CONFIG``), on every device the machine has:

    PYTHONPATH=src python scripts/costmodel_mape.py

The points are labelled once, over the oneshot search's joint space
(full-width MobileNetV2's kernel / expansion / op choices at 32 px, 10
classes, times the accelerator space, seed 0, with energy). The port trains
on the CPU, and on the card where there is one, four times on each: with
the dropout masks drawn from seeds 0, 1 and 2 (the init and the batches
are the same in every run and on every device), and with dropout 0. Where
the JAX package imports, its reference trains on the same points as well,
on the CPU and on jax's GPU backend where there is one: its init and
dropout draws are its own, and the same on both backends, so the two
differ only in how each rounds fp32 (the order of its sums, its elementary
functions; its matmuls in full fp32 on both, as the port's are). Prints
one JSON line per run.
"""
from __future__ import annotations

import dataclasses
import json
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402  (the settings, and it puts src/ on the path)
from repro_torch.core import costmodel, has, oneshot  # noqa: E402

DROPOUT_SEEDS = (0, 1, 2)


def main() -> None:
    cfg = chip_smoke.COST_CONFIG
    t0 = time.perf_counter()
    feats, lat, area, energy = costmodel.generate_dataset(
        oneshot.oneshot_space(chip_smoke._oneshot_base()), has.has_space(),
        chip_smoke.COST_POINTS, seed=0, include_energy=True)
    print(json.dumps({"labelled": chip_smoke.COST_POINTS, "features": int(feats.shape[1]),
                      "host_s": time.perf_counter() - t0}), flush=True)
    runs = []
    for device in ["cpu"] + (["cuda"] if torch.cuda.is_available() else []):
        for seed in DROPOUT_SEEDS:
            runs.append(({"impl": "port", "device": device, "dropout": cfg.dropout,
                          "dropout_seed": seed},
                         lambda d=device, s=seed: costmodel.train(
                             feats, lat, area, cfg, energy_mj=energy, device=d,
                             dropout_seed=s)))
        runs.append(({"impl": "port", "device": device, "dropout": 0.0},
                     lambda d=device: costmodel.train(
                         feats, lat, area, dataclasses.replace(cfg, dropout=0.0),
                         energy_mj=energy, device=d)))
    try:
        import jax
        from repro.core import costmodel as ref  # the JAX reference
    except ImportError:
        ref = None
    if ref is not None:
        for backend in ("cpu", "gpu"):
            try:
                device = jax.devices(backend)[0]
            except RuntimeError:  # no such backend here
                continue

            def fn(device=device):
                with jax.default_device(device), jax.default_matmul_precision("highest"):
                    return ref.train(feats, lat, area, ref.CostModelConfig(**vars(cfg)),
                                     energy_mj=energy)

            runs.append(({"impl": "reference", "device": f"jax {backend}",
                          "dropout": cfg.dropout}, fn))
    for tags, fn in runs:
        if tags["device"] == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, metrics = fn()
        wall = time.perf_counter() - t0
        print(json.dumps({**tags, "steps": cfg.steps, "wall_s": wall,
                          "ms_per_step": wall / cfg.steps * 1e3, **metrics}), flush=True)


if __name__ == "__main__":
    main()
