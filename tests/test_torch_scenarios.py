"""The port's scenario registry held against the JAX reference: the LLM
scenario grid (all 324 scenarios, in order, field for field), the
scenario-transfer embedding ``features`` (bitwise, on the grid and on the
paper's presets), and registration that touches only the port's registry.
The reference's grid is computed once for the module."""
import dataclasses
import functools

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core import scenarios as ref  # noqa: E402
from repro_torch.core import scenarios as port  # noqa: E402


@functools.lru_cache(maxsize=None)
def _ref_grid():
    return tuple(ref.grid(register_scenarios=False))


@functools.lru_cache(maxsize=None)
def _port_grid():
    before = ref.names()
    out = tuple(port.grid())
    assert ref.names() == before  # the reference's registry is untouched
    return out


def _fields(sc):
    return type(sc).__name__, dataclasses.astuple(sc)


def test_grid_axes_are_the_references():
    for name in ("GRID_MODELS", "GRID_MODES", "GRID_SEQ_LENS", "GRID_SKUS", "GRID_TIERS",
                 "GRID_LATENCY_CLIP_MS", "WORKLOAD_FEATURE_KEYS", "FEATURE_NAMES"):
        assert getattr(port, name) == getattr(ref, name), name


def test_grid_matches_reference():
    got, want = _port_grid(), _ref_grid()
    assert len(got) == len(want) == 324
    assert [_fields(s) for s in got] == [_fields(s) for s in want]
    assert len({s.name for s in got}) == 324
    lo, hi = port.GRID_LATENCY_CLIP_MS
    assert all(lo <= s.latency_target_ms <= hi for s in got)


def test_grid_features_bitwise():
    got = np.stack([port.features(s) for s in _port_grid()])
    want = np.stack([ref.features(s) for s in _ref_grid()])
    assert got.shape == (324, len(port.FEATURE_NAMES))
    assert got.tobytes() == want.tobytes()
    assert len({row.tobytes() for row in got}) == 324


def test_preset_features_bitwise():
    names = sorted({n for group in port.PRESETS.values() for n in group})
    assert names == sorted({n for group in ref.PRESETS.values() for n in group})
    for name in names:
        assert _fields(port.get(name)) == _fields(ref.get(name))
        assert port.features(port.get(name)).tobytes() == ref.features(ref.get(name)).tobytes()


def test_grid_registers_in_the_ports_registry_only():
    grid = _port_grid()
    registered = set(port.names())
    assert {s.name for s in grid} <= registered
    # re-running overwrites the same names (idempotent), and a limit cuts the
    # same prefix
    again = port.grid(limit=30)
    assert [_fields(s) for s in again] == [_fields(s) for s in grid[:30]]
    assert set(port.names()) == registered
    assert port.expand(grid[0].name) == [grid[0]]
