"""Shared utilities of the PyTorch port: dtypes, name-folded generators,
parameter-tree helpers (leaves, paths, casts, the global norm), integer
helpers and the bounded FIFO memo.

Counterpart of ``repro/common.py``. Imports torch and numpy only.
"""
from __future__ import annotations

import hashlib
from typing import Any, Callable

import numpy as np
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


def fold_seed(seed: int, *names: str, device="cpu") -> torch.Generator | None:
    """A ``torch.Generator`` on ``device`` seeded from ``seed`` and string
    names (stable across runs and processes). The counterpart of
    ``repro.common.fold_rng``; it does not reproduce ``jax.random``'s
    streams, so the port's inits match the reference only in distribution.

    On the ``meta`` device (a shape-only init: ``train.steps.abstract_params``)
    there is nothing to draw, and torch has no meta generator: it returns
    ``None``."""
    if torch.device(device).type == "meta":
        return None
    h = hashlib.sha256(str(int(seed)).encode())
    for name in names:
        h.update(b"/" + name.encode())
    return torch.Generator(device=device).manual_seed(
        int.from_bytes(h.digest()[:8], "little") >> 1)


def tree_size(tree: PyTree) -> int:
    """Total number of elements across all leaves."""
    return sum(t.numel() for t in tree_leaves(tree))


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
    return _rebuild(tree, iter(leaves))


def _rebuild(t: PyTree, it) -> PyTree:
    # a module-level recursion: a nested function that calls itself is a
    # reference cycle, which would keep ``leaves`` (gradients, a whole
    # state) alive until the cyclic collector runs
    if isinstance(t, dict):
        return {k: _rebuild(v, it) for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        return type(t)(_rebuild(x, it) for x in t)
    return next(it)


def tree_from_numpy(np_tree: PyTree, device="cuda") -> PyTree:
    """A tree of numpy arrays (a reference parameter tree after
    ``jax.tree.map(np.asarray, ...)``) as tensors on ``device``, with the
    same nesting; bfloat16 arrays stay bfloat16."""
    leaves = []
    for a in tree_leaves(np_tree):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":  # numpy has no bfloat16 of its own
            t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
        else:
            t = torch.from_numpy(a.copy())
        leaves.append(t.to(device))
    return tree_unflatten(np_tree, leaves)


def tree_cast(tree: PyTree, dtype) -> PyTree:
    """Every floating-point leaf cast to ``dtype`` (a leaf already of that
    type is returned as is); integer leaves unchanged."""
    dtype = dtype_of(dtype)
    return tree_map(lambda t: t.to(dtype) if t.is_floating_point() else t, tree)


def global_norm(tree: PyTree) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's fp32 sum of squares: a 0-d
    fp32 tensor on the leaves' device."""
    sums = [t.float().square().sum() for t in tree_leaves(tree)]
    return torch.sqrt(torch.stack(sums).sum())


def tree_paths(tree: PyTree, _prefix: tuple = ()) -> list[tuple[str, Any]]:
    """Flatten a tree into ('a/b/0', leaf) pairs: dict keys and sequence
    indices joined by '/', dict keys in sorted order and ``None`` holding no
    leaf, as ``jax.tree_util`` flattens a tree. The names are a checkpoint's
    array names, the same for the reference's tree and the port's."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [pair for k in sorted(tree) for pair in tree_paths(tree[k], _prefix + (str(k),))]
    if isinstance(tree, (list, tuple)):
        return [pair for i, t in enumerate(tree) for pair in tree_paths(t, _prefix + (str(i),))]
    return [("/".join(_prefix), tree)]


def tree_unflatten_paths(tree: PyTree, leaves: list) -> PyTree:
    """Inverse of ``tree_paths``: ``tree``'s structure with ``leaves`` taken
    in ``tree_paths``' order (dict keys sorted, ``None`` kept as it is)."""
    return _rebuild_sorted(tree, iter(leaves))


def _rebuild_sorted(t: PyTree, it) -> PyTree:
    if t is None:
        return None
    if isinstance(t, dict):
        new = {k: _rebuild_sorted(t[k], it) for k in sorted(t)}
        return {k: new[k] for k in t}
    if isinstance(t, (list, tuple)):
        return type(t)(_rebuild_sorted(x, it) for x in t)
    return next(it)


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
