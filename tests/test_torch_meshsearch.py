"""The port's pod mesh search held against the JAX reference on the CPU:
``search_mesh(mamba2-370m, train_4k, samples=96, seed=0)`` samples the same
configs, scores them with bitwise-equal records, finds the same best config
and ends with PPO logits within 1e-5 of the reference's. The controllers are
recorded by a subclass of each side's ``PPOController``."""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro import configs as ref_configs  # noqa: E402
from repro.config import SHAPES as REF_SHAPES  # noqa: E402
from repro.core import meshsearch as ref_mesh  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.config import SHAPES  # noqa: E402
from repro_torch.core import meshsearch  # noqa: E402

CTRL_TOL = 1e-5
SAMPLES = 96


def _recorded(module, monkeypatch):
    """Swap ``module.PPOController`` for a subclass that keeps its instances."""
    made = []

    class Recorded(module.PPOController):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            made.append(self)

    monkeypatch.setattr(module, "PPOController", Recorded)
    return made


def test_search_mesh_matches_reference(monkeypatch):
    ref_ctrls = _recorded(ref_mesh, monkeypatch)
    port_ctrls = _recorded(meshsearch, monkeypatch)
    want = ref_mesh.search_mesh(ref_configs.get("mamba2-370m"), REF_SHAPES["train_4k"],
                                samples=SAMPLES, seed=0)
    got = meshsearch.search_mesh(configs.get("mamba2-370m"), SHAPES["train_4k"],
                                 samples=SAMPLES, seed=0, device="cpu")
    assert len(got.history) == len(want.history) == SAMPLES
    # the first batch comes from the untouched initial logits: bitwise
    assert repr(got.history[:16]) == repr(want.history[:16])
    mismatched = 0
    for g, w in zip(got.history, want.history):
        if g["config"] != w["config"]:
            mismatched += 1
            continue
        assert repr(g) == repr(w)
    assert mismatched == 0
    assert got.best == want.best and got.best_cfg == want.best_cfg
    assert got.best["step_s"] > 0
    # the history's configs are distinct objects (un-aliased from the cache)
    assert len({id(h["config"]) for h in got.history}) == SAMPLES
    (ref_ctrl,), (port_ctrl,) = ref_ctrls, port_ctrls
    assert port_ctrl.device.type == "cpu"
    err = np.max(np.abs(port_ctrl.logits.numpy() - np.asarray(ref_ctrl.logits)))
    assert err < CTRL_TOL
