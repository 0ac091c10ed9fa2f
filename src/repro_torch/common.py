"""Shared utilities of the PyTorch port: dtypes, name-folded generators,
parameter-tree helpers, integer helpers and the bounded FIFO memo.

Counterpart of ``repro/common.py``. Imports torch and numpy only.
"""
from __future__ import annotations

import hashlib
from typing import Any, Callable

import torch

PyTree = Any

_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
    "int8": torch.int8,
    "int32": torch.int32,
}


def dtype_of(name: str | torch.dtype) -> torch.dtype:
    if isinstance(name, str):
        return _DTYPES[name]
    return name


def fold_seed(seed: int, *names: str) -> torch.Generator:
    """A CPU ``torch.Generator`` seeded from ``seed`` and string names
    (stable across runs and processes). The counterpart of
    ``repro.common.fold_rng``; it does not reproduce ``jax.random``'s
    streams, so the port's inits match the reference only in distribution."""
    h = hashlib.sha256(str(int(seed)).encode())
    for name in names:
        h.update(b"/" + name.encode())
    return torch.Generator().manual_seed(int.from_bytes(h.digest()[:8], "little") >> 1)


def tree_leaves(tree: PyTree) -> list:
    """Leaves of a nested dict/list/tuple tree, in insertion order."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [leaf for t in tree for leaf in tree_leaves(t)]
    return [tree]


def tree_map(fn: Callable, tree: PyTree, *rest: PyTree) -> PyTree:
    """``fn`` over matching leaves of trees with the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, t, *(r[i] for r in rest))
                          for i, t in enumerate(tree))
    return fn(tree, *rest)


def tree_unflatten(tree: PyTree, leaves: list) -> PyTree:
    """Inverse of ``tree_leaves``: ``tree``'s structure with ``leaves``."""
    it = iter(leaves)

    def rebuild(t):
        if isinstance(t, dict):
            return {k: rebuild(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(rebuild(x) for x in t)
        return next(it)

    return rebuild(tree)


def ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def round_up(a: int, b: int) -> int:
    return ceil_div(a, b) * b


class FifoDict(dict):
    """A dict that evicts its oldest entry (insertion order) at a size cap —
    the ``engine.RecordStore`` eviction pattern as a reusable container.

    Drop-in for the module-level memo caches (``simulator._MATRIX_CACHE``,
    ``proxy.CachedAccuracy``): a full cache sheds one cold entry per insert
    instead of dumping the whole working set, so steady-state hit rates
    survive the cap. Evictions are counted in ``self.evictions``.

    Unlocked, like the plain dicts it replaces — but those caches may be
    written from concurrent searches, so the evict step tolerates races: a
    key another thread already evicted (KeyError) or an iterator
    invalidated mid-eviction (RuntimeError) just retries against the
    re-checked size.
    """

    def __init__(self, max_entries: int):
        super().__init__()
        self.max_entries = max_entries
        self.evictions = 0

    def __setitem__(self, key, value) -> None:
        if key not in self:
            while len(self) >= self.max_entries:
                try:
                    super().__delitem__(next(iter(self)))
                    self.evictions += 1
                except (KeyError, RuntimeError, StopIteration):
                    continue  # racing evictor got there first; re-check size
        super().__setitem__(key, value)
