"""Synthetic data pipelines.

All generators are *deterministic in (seed, step, host_id)* so that
  * a restarted job regenerates the exact stream (fault-tolerant resume
    without data-state checkpoints),
  * each host of a multi-host job draws only its slice (host-sharded loading).

Counterpart of ``repro/data/synthetic.py``: ``VisionStream`` (the NAS proxy
task) is a copy; the LM stream waits for the LLM slice.
"""
from __future__ import annotations

import dataclasses

import numpy as np


def _rng_for(seed: int, step: int, host: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([seed, step, host]))



@dataclasses.dataclass
class VisionStream:
    """Class-conditional Gaussian blobs: learnable image classification for the
    NAS proxy task (the paper's ImageNet stand-in)."""

    image_size: int = 32
    num_classes: int = 10
    batch: int = 64
    seed: int = 0
    host: int = 0
    noise: float = 0.6

    def __post_init__(self):
        g = _rng_for(self.seed, 0, 0)
        self._protos = g.normal(
            0, 1, size=(self.num_classes, self.image_size, self.image_size, 3)
        ).astype(np.float32)

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        g = _rng_for(self.seed, step + 1, self.host)
        y = g.integers(0, self.num_classes, size=self.batch)
        x = self._protos[y] + g.normal(0, self.noise, size=(
            self.batch, self.image_size, self.image_size, 3)).astype(np.float32)
        return {"images": x.astype(np.float32), "labels": y.astype(np.int32)}

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1

