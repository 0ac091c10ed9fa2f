"""Nested dicts of tensors (a parameter tree) as (path, leaf) pairs and
back, in the dicts' insertion order. Used by the harness and by the
reference alike; imports nothing but the standard library."""
from __future__ import annotations


def leaves(tree, prefix: tuple = ()) -> list[tuple[tuple, object]]:
    """[(path, leaf)] of a tree of dicts, depth first, in insertion order."""
    if isinstance(tree, dict):
        return [pair for k, v in tree.items() for pair in leaves(v, prefix + (k,))]
    return [(prefix, tree)]


def build(pairs) -> dict:
    """The tree of dicts that ``leaves`` flattened into ``pairs``."""
    out: dict = {}
    for path, leaf in pairs:
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out


def name(path: tuple) -> str:
    return "/".join(str(p) for p in path)


def slices(tree, layers_key: str = "layers") -> list[tuple[str, object]]:
    """(name, tensor) of every leaf, a leaf under ``layers_key`` (an
    L-leading stack) cut into its L layers: the units by which training
    readings are compared, so that one layer's fault is not averaged over
    the stack."""
    out = []
    for path, t in leaves(tree):
        if path and path[0] == layers_key:
            out += [(f"{name(path)}[{i}]", t[i]) for i in range(t.shape[0])]
        else:
            out.append((name(path), t))
    return out
