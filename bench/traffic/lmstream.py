"""The token stream of every traffic mix: a frozen copy of ``LMStream``
from ``src/repro_torch/data/synthetic.py`` at commit cbce191 (itself a copy
of ``src/repro/data/synthetic.py``), numpy only. An order-2 Markov chain
over at most 4,096 token ids, so the loss has real structure below log V.

Only ``batch_at`` is kept; the copy draws the same tokens as the original
for the same arguments."""
from __future__ import annotations

import dataclasses

import numpy as np


def _rng_for(seed: int, step: int, host: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([seed, step, host]))


@dataclasses.dataclass
class LMStream:
    vocab_size: int
    seq_len: int
    batch: int
    seed: int = 0
    host: int = 0
    order_states: int = 64

    def __post_init__(self):
        g = _rng_for(self.seed, 0, 0)
        v = min(self.vocab_size, 4096)
        self._v = v
        probs = g.dirichlet(np.full(8, 0.3), size=self.order_states)
        succ = g.integers(0, v, size=(self.order_states, 8))
        self._succ = succ
        self._probs = probs

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        g = _rng_for(self.seed, step + 1, self.host)
        b, s = self.batch, self.seq_len
        toks = np.empty((b, s), np.int32)
        state = g.integers(0, self.order_states, size=b)
        cdf = np.cumsum(self._probs, axis=1)
        u = g.random((b, s))
        for t in range(s):
            choice = (u[:, t, None] > cdf[state]).sum(axis=1)
            toks[:, t] = self._succ[state, choice]
            state = (state * 31 + toks[:, t]) % self.order_states
        labels = np.concatenate([toks[:, 1:], np.full((b, 1), -1, np.int32)], axis=1)
        return {"tokens": toks, "labels": labels}
