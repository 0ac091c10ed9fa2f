"""Synthetic data pipelines.

All generators are *deterministic in (seed, step, host_id)* so that
  * a restarted job regenerates the exact stream (fault-tolerant resume
    without data-state checkpoints),
  * each host of a multi-host job draws only its slice (host-sharded loading).

The LM stream is an order-2 Markov chain over the vocab, so cross-entropy has
real learnable structure (entropy well below log V) — training curves in the
examples show genuine learning, not noise fitting.

Counterpart of ``repro/data/synthetic.py``, numpy only: a copy, whose
batches are bitwise the reference's.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator, Optional

import numpy as np

from repro_torch.config import ModelConfig, ShapeConfig


def _rng_for(seed: int, step: int, host: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([seed, step, host]))


@dataclasses.dataclass
class LMStream:
    vocab_size: int
    seq_len: int
    batch: int  # per-host batch
    seed: int = 0
    host: int = 0
    order_states: int = 64  # markov states (kept small => low entropy)

    def __post_init__(self):
        g = _rng_for(self.seed, 0, 0)  # transition table shared by all hosts
        v = min(self.vocab_size, 4096)
        self._v = v
        # sparse-ish transitions: each state prefers ~4 successors
        probs = g.dirichlet(np.full(8, 0.3), size=self.order_states)
        succ = g.integers(0, v, size=(self.order_states, 8))
        self._succ = succ
        self._probs = probs

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        g = _rng_for(self.seed, step + 1, self.host)
        b, s = self.batch, self.seq_len
        toks = np.empty((b, s), np.int32)
        state = g.integers(0, self.order_states, size=b)
        cdf = np.cumsum(self._probs, axis=1)  # (states, 8)
        u = g.random((b, s))
        for t in range(s):  # vectorized over batch; inverse-CDF sampling
            choice = (u[:, t, None] > cdf[state]).sum(axis=1)
            toks[:, t] = self._succ[state, choice]
            state = (state * 31 + toks[:, t]) % self.order_states
        labels = np.concatenate([toks[:, 1:], np.full((b, 1), -1, np.int32)], axis=1)
        return {"tokens": toks, "labels": labels}

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1



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



class Prefetcher:
    """Background-thread prefetch with bounded queue (double buffering)."""

    def __init__(self, it: Iterator, depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._it = it
        self._done = object()
        self._t = threading.Thread(target=self._run, daemon=True)
        self._t.start()

    def _run(self):
        try:
            for item in self._it:
                self._q.put(item)
        finally:
            self._q.put(self._done)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._done:
            raise StopIteration
        return item


def stream_for(cfg: ModelConfig, shape: ShapeConfig, seed: int = 0, host: int = 0,
               per_host_batch: Optional[int] = None) -> LMStream:
    return LMStream(
        vocab_size=cfg.vocab_size,
        seq_len=shape.seq_len,
        batch=per_host_batch or shape.global_batch,
        seed=seed,
        host=host,
    )
