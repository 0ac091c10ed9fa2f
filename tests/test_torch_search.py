"""The port's search stack held against the JAX reference: engine records
(bitwise), the PPO / REINFORCE updates (within 1e-5 from one reference
state), the evolution search (bitwise), and a CPU run of the joint search
with real proxy training. Inputs come from numpy seeds."""
import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import controllers as ref_ctl  # noqa: E402
from repro.core import engine as ref_engine  # noqa: E402
from repro.core import has as ref_has  # noqa: E402
from repro.core import nas as ref_nas  # noqa: E402
from repro.core import proxy as ref_proxy  # noqa: E402
from repro.core import reward as ref_reward  # noqa: E402
from repro.core import search as ref_search  # noqa: E402
from repro.core import session as ref_session  # noqa: E402
from repro.core import simulator as ref_sim  # noqa: E402
from repro.core.space import concat  # noqa: E402
from repro_torch.core import controllers as port_ctl  # noqa: E402
from repro_torch.core import engine as port_engine  # noqa: E402
from repro_torch.core import has as port_has  # noqa: E402
from repro_torch.core import meshsearch as port_meshsearch  # noqa: E402
from repro_torch.core import nas as port_nas  # noqa: E402
from repro_torch.core import proxy as port_proxy  # noqa: E402
from repro_torch.core import reward as port_reward  # noqa: E402
from repro_torch.core import search as port_search  # noqa: E402
from repro_torch.core import session as port_session  # noqa: E402

CTRL_TOL = 1e-5


def _rcfg(lib, latency=0.5):
    return lib.RewardConfig(latency_target_ms=latency,
                            area_target_mm2=ref_sim.BASELINE_AREA_MM2)


def _joint_vecs(space_name, n=64, seed=11):
    nas_space = ref_nas.SPACES[space_name]()
    has_space = ref_has.has_space()
    rng = np.random.default_rng(seed)
    vecs = np.stack([concat(nas_space, has_space).sample(rng) for _ in range(n)])
    # half of them on the baseline accelerator, so most of those simulate valid
    vecs[::2, nas_space.num_decisions:] = ref_has.baseline_vec(has_space)
    return vecs


@pytest.mark.parametrize("space_name", ["s1_mbv2", "s3_evolved", "tiny"])
def test_engine_records_bitwise_equal(space_name):
    vecs = _joint_vecs(space_name)
    ref = ref_engine.EvaluationEngine(
        ref_nas.SPACES[space_name](), ref_has.has_space(),
        ref_proxy.SurrogateAccuracy(), _rcfg(ref_reward))
    port = port_engine.EvaluationEngine(
        port_nas.SPACES[space_name](), port_has.has_space(),
        port_proxy.SurrogateAccuracy(), _rcfg(port_reward))
    want = ref.evaluate_batch(vecs)
    got = port.evaluate_batch(vecs)
    assert sum(r["valid"] for r in want) >= 8
    assert got == want
    # the port's records live in a store namespace of their own
    assert port._ns != ref._ns


def _states_close(a, b):
    for key in ("m", "v"):
        assert np.max(np.abs(a["adam"][key] - b["adam"][key])) < CTRL_TOL
    assert a["adam"]["t"] == b["adam"]["t"]
    assert np.max(np.abs(a["logits"] - b["logits"])) < CTRL_TOL


@pytest.mark.parametrize("kind", ["ppo", "reinforce"])
def test_controller_updates_match_reference(kind):
    ref = ref_ctl.CONTROLLERS[kind](ref_nas.tiny_space(), seed=5)
    port = port_ctl.CONTROLLERS[kind](port_nas.tiny_space(), seed=5, device="cpu")
    rng = np.random.default_rng(0)
    ref.update(ref.sample(8), rng.normal(size=8))  # a state past the first step
    port.load_state(ref.state())
    for _ in range(3):
        vecs = ref.sample(8)
        assert np.array_equal(port.sample(8), vecs)
        rewards = rng.normal(size=8)
        ref.update(vecs, rewards)
        port.update(vecs, rewards)
        _states_close(port.state(), ref.state())
    assert np.array_equal(port.sample(16), ref.sample(16))
    # and the port's state() loads into the reference
    back = ref_ctl.CONTROLLERS[kind](ref_nas.tiny_space(), seed=9)
    back.load_state(port.state())
    assert np.array_equal(back.sample(16), port.sample(16))


def test_warm_start_matches_reference():
    space_r, space_t = ref_nas.tiny_space(), port_nas.tiny_space()
    ref = ref_ctl.PPOController(concat(space_r, ref_has.has_space()), seed=1)
    port = port_ctl.PPOController(concat(space_t, port_has.has_space()), seed=1,
                                  device="cpu")
    base = ref_has.baseline_vec(ref_has.has_space())
    ref.warm_start(space_r.num_decisions, base, 1.5)
    port.warm_start(space_t.num_decisions, base, 1.5)
    assert np.array_equal(port.state()["logits"], np.asarray(ref.logits))
    assert np.array_equal(port.sample(32), ref.sample(32))


def test_evolution_joint_search_matches_reference():
    kw = dict(samples=32, batch=8, controller="evolution", seed=0)
    want = ref_session.SearchSession(
        ref_nas.tiny_space(), ref_proxy.SurrogateAccuracy(),
        cfg=ref_search.SearchConfig(**kw)).joint(rcfg=_rcfg(ref_reward))
    got = port_session.SearchSession(
        port_nas.tiny_space(), port_proxy.SurrogateAccuracy(),
        cfg=port_search.SearchConfig(**kw)).joint(rcfg=_rcfg(port_reward))
    assert got.history == want.history
    assert np.array_equal(got.best_vec, want.best_vec)
    assert got.best_record == want.best_record


def test_joint_search_with_trained_accuracy_on_cpu():
    acc = port_proxy.TrainedAccuracy(steps=2, batch=8, eval_batches=1, device="cpu")
    res = port_session.SearchSession(
        port_nas.tiny_space(), acc,
        cfg=port_search.SearchConfig(samples=8, batch=4, seed=0, device="cpu"),
    ).joint(rcfg=_rcfg(port_reward, latency=0.05))
    assert len(res.history) == 8
    trained = [h for h in res.history if h["valid"]]
    assert trained and all(0.0 <= h["accuracy"] <= 1.0 for h in trained)
    assert res.best_record is not None and res.best_record["valid"]


def test_entry_points_default_to_the_card():
    assert port_proxy.TrainedAccuracy().device == "cuda"
    assert port_search.SearchConfig().device == "cuda"
    device = inspect.signature(port_meshsearch.search_mesh).parameters["device"]
    assert device.default == "cuda"


def test_runtime_arguments_raise_until_ported(tmp_path):
    with pytest.raises(NotImplementedError, match="runtime"):
        port_session.SearchSession(port_nas.tiny_space(),
                                   port_proxy.SurrogateAccuracy(),
                                   checkpoint_dir=str(tmp_path))
