"""A small symbolic search-space library (stands in for PyGlove in the paper:
"we can replace any static node in a computational graph with a tunable node").

A search space is a list of named ``Choice`` decision points. Configurations
are integer vectors (one index per decision), which keeps controllers simple
(factorized categorical policies) and featurization trivial.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class Choice:
    name: str
    options: tuple

    def __len__(self) -> int:
        return len(self.options)


def _space_from_state(cls, state: dict) -> "Space":
    sp = cls.__new__(cls)
    sp.__dict__.update(state)
    return sp


def _space_from_provenance(path: str, kw_items: tuple) -> "Space":
    """Pickle reconstructor: re-run the registered factory (see
    ``Space.provenance``) — spaces are code, so shipping the factory call
    instead of the decoder closure is what makes them process-portable."""
    import importlib

    mod_name, _, fn_name = path.partition(":")
    return getattr(importlib.import_module(mod_name), fn_name)(**dict(kw_items))


@dataclasses.dataclass
class Space:
    """An ordered set of decision points + a decoder into a concrete config.

    ``provenance`` — optional ``("module:factory", kwargs)`` stamped by the
    registered space factories (``nas.SPACES``, ``has.has_space``): a space
    carrying it pickles as the factory call and is rebuilt bit-identically in
    another process (the multi-process executor ships jobs this way); without
    it, pickling falls back to the default path, which fails on the decoder
    closure."""

    choices: list[Choice]
    decoder: Callable[[dict], Any] = lambda d: d
    name: str = "space"
    provenance: Any = None

    def __reduce__(self):
        if self.provenance is not None:
            path, kw = self.provenance
            return (_space_from_provenance, (path, tuple(sorted(kw.items()))))
        return (_space_from_state, (self.__class__, dict(self.__dict__)))

    @property
    def num_decisions(self) -> int:
        return len(self.choices)

    @property
    def arity(self) -> list[int]:
        return [len(c) for c in self.choices]

    @property
    def cardinality(self) -> float:
        out = 1.0
        for c in self.choices:
            out *= len(c)
        return out

    def sample(self, rng: np.random.Generator) -> np.ndarray:
        return np.array([rng.integers(0, len(c)) for c in self.choices], np.int32)

    def decode(self, vec: Sequence[int]) -> Any:
        d = {c.name: c.options[int(v)] for c, v in zip(self.choices, vec)}
        return self.decoder(d)

    def to_dict(self, vec: Sequence[int]) -> dict:
        return {c.name: c.options[int(v)] for c, v in zip(self.choices, vec)}

    def to_dict_batch(self, vecs: np.ndarray) -> list[dict]:
        """Decision dicts for a whole (N, num_decisions) batch at once —
        option lookup runs per column instead of per (vector, decision), which
        is what lets the EvaluationEngine decode controller batches cheaply.
        Equivalent to ``[self.to_dict(v) for v in vecs]``."""
        vecs = np.asarray(vecs)
        names = [c.name for c in self.choices]
        cols = [
            [c.options[k] for k in vecs[:, j].tolist()]
            for j, c in enumerate(self.choices)
        ]
        return [dict(zip(names, row)) for row in zip(*cols)]

    def decode_batch(self, vecs: np.ndarray) -> list:
        """Batched ``decode`` (one decoder call per vector, shared option
        lookup)."""
        return [self.decoder(d) for d in self.to_dict_batch(vecs)]

    def features(self, vec: Sequence[int]) -> np.ndarray:
        """One-hot featurization (the cost model input)."""
        out = []
        for c, v in zip(self.choices, vec):
            oh = np.zeros(len(c), np.float32)
            oh[int(v)] = 1.0
            out.append(oh)
        return np.concatenate(out)

    @property
    def feature_dim(self) -> int:
        return sum(len(c) for c in self.choices)

    def mutate(self, vec: np.ndarray, rng: np.random.Generator,
               rate: float = 0.1) -> np.ndarray:
        out = vec.copy()
        for i, c in enumerate(self.choices):
            if rng.random() < rate:
                out[i] = rng.integers(0, len(c))
        return out


def concat(a: Space, b: Space, decoder=None, name="joint") -> Space:
    """The paper's unified joint space: NAS ++ HAS decision points."""

    def dec(d):
        da = {c.name: d[c.name] for c in a.choices}
        db = {c.name: d[c.name] for c in b.choices}
        if decoder is not None:
            return decoder(a.decoder(da), b.decoder(db))
        return (a.decoder(da), b.decoder(db))

    return Space(list(a.choices) + list(b.choices), dec, name)


def split_vec(joint: Space, a: Space, vec: np.ndarray):
    na = a.num_decisions
    return vec[:na], vec[na:]
