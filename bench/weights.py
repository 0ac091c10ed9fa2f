"""Weights from ``--seed``, drawn on the device, one draw per leaf (a
layer-stacked leaf is one draw for all its layers), in the type the
configuration serves them in. The benchmark makes them and hands the same
values to the program and to the reference.

Each leaf has a generator of its own, seeded from the run's seed and the
leaf's path, so that one leaf can be drawn again alone (the training check
compares each leaf's change against its first value). The distributions
are the published ones of the families the configurations use: N(0, 1/fan_in)
for products (fan_in the second-to-last axis), N(0, 0.02) for the token
embedding, ones for norm scales and the SSM skip D, zeros for biases, and
Mamba2's own ranges for A (-[1, 16]) and the step dt (softplus of dt_bias in
[1e-3, 1e-1], log-uniform).
"""
from __future__ import annotations

import hashlib
import math

import torch

from bench import tree as T


def generator(seed: int, *names: str, device="cuda") -> torch.Generator:
    """A generator on ``device`` from a seed of any size and some names."""
    h = hashlib.sha256(str(int(seed)).encode())
    for n in names:
        h.update(b"/" + n.encode())
    return torch.Generator(device=device).manual_seed(
        int.from_bytes(h.digest()[:8], "little") >> 1)


def draw(path: tuple, shape, dtype, seed: int, device="cuda") -> torch.Tensor:
    """The leaf at ``path`` (its last key names its kind)."""
    key = path[-1]
    shape = tuple(shape)
    gen = generator(seed, "weights", *map(str, path), device=device)

    def uniform(lo, hi):
        u = torch.rand(shape, generator=gen, device=device, dtype=torch.float32)
        return u.mul_(hi - lo).add_(lo)

    if key in ("scale", "D"):
        w = torch.ones(shape, device=device, dtype=torch.float32)
    elif key.endswith("_b"):
        w = torch.zeros(shape, device=device, dtype=torch.float32)
    elif key == "A_log":
        w = torch.log(uniform(1.0, 16.0))
    elif key == "dt_bias":
        dt = torch.exp(uniform(math.log(1e-3), math.log(0.1)))
        w = dt + torch.log(-torch.expm1(-dt))  # softplus(dt_bias) = dt
    elif key == "embedding":
        w = torch.randn(shape, generator=gen, device=device, dtype=torch.float32).mul_(0.02)
    else:
        fan_in = shape[-2]
        w = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
        w.mul_(1.0 / math.sqrt(fan_in))
    return w.to(dtype)


def make(layout, seed: int, device="cuda") -> dict:
    """A tree shaped as ``layout`` (a tree of tensors that give each leaf's
    shape and dtype, such as meta tensors) with every leaf drawn."""
    return T.build((path, draw(path, t.shape, t.dtype, seed, device))
                   for path, t in T.leaves(layout))
