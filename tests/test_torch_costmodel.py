"""The port's learned cost model held against the JAX package's: the
labelled dataset (bitwise), the MLP's init shapes and statistics, its
forward on converted parameters, a whole training run from the reference's
init (dropout 0), the reference's own learning check, and the learned
backend's records. Inputs come from numpy seeds; everything runs on the
CPU."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro.core import costmodel as R  # noqa: E402
from repro.core import engine as ref_engine  # noqa: E402
from repro.core import has as ref_has  # noqa: E402
from repro.core import nas as ref_nas  # noqa: E402
from repro.core import proxy as ref_proxy  # noqa: E402
from repro.core import reward as ref_reward  # noqa: E402
from repro.hw import LearnedBackend as RefLearned  # noqa: E402
from repro_torch.common import tree_leaves  # noqa: E402
from repro_torch.core import costmodel as T  # noqa: E402
from repro_torch.core import engine as port_engine  # noqa: E402
from repro_torch.core import has, nas, proxy, reward, simulator  # noqa: E402
from repro_torch.hw import LearnedBackend  # noqa: E402

FWD_TOL = 1e-5
PARAM_TOL = 1e-4
METRIC_TOL = 1e-4
RECORD_TOL = 1e-5


@pytest.fixture(scope="module")
def data():
    """300 labelled points of tiny_space x has_space, with energy."""
    return R.generate_dataset(ref_nas.tiny_space(), ref_has.has_space(), 300, seed=0,
                              include_energy=True)


def _ref_params(in_dim, energy, seed=0, cfg=R.CostModelConfig()):
    return jax.tree.map(np.asarray, R.init_mlp(jax.random.PRNGKey(seed), in_dim, cfg, energy))


@pytest.mark.parametrize("energy", [False, True])
def test_generate_dataset_is_bitwise(energy):
    want = R.generate_dataset(ref_nas.tiny_space(), ref_has.has_space(), 300, seed=0,
                              include_energy=energy)
    got = T.generate_dataset(nas.tiny_space(), has.has_space(), 300, seed=0,
                             include_energy=energy)
    assert len(got) == len(want) == (4 if energy else 3)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)


def test_init_mlp_has_the_reference_shapes_and_statistics():
    cfg = T.CostModelConfig()
    got = T.init_mlp(torch.Generator().manual_seed(0), 116, cfg, energy=True, device="cpu")
    want = _ref_params(116, True)
    assert sorted(got) == sorted(want)
    pairs = [(got["layers"][i], want["layers"][i]) for i in range(cfg.layers)]
    pairs += [(got[h], want[h]) for h in ("head_lat", "head_area", "head_energy")]
    for g, w in pairs:
        assert tuple(g["w"].shape) == w["w"].shape and tuple(g["b"].shape) == w["b"].shape
        assert g["w"].dtype == torch.float32
        assert not g["b"].any() and not w["b"].any()
        # the same distribution: He-normal trunk, N(0, 0.01^2) heads
        assert float(g["w"].std()) == pytest.approx(float(w["w"].std()), rel=0.1)
        assert abs(float(g["w"].mean())) < 3 * float(w["w"].std()) / np.sqrt(w["w"].size)
    # the same seed gives the same parameters wherever they are put
    again = T.init_mlp(torch.Generator().manual_seed(0), 116, cfg, energy=True, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(got), tree_leaves(again)))
    # without the energy head the trunk and the other heads are unchanged
    two = T.init_mlp(torch.Generator().manual_seed(0), 116, cfg, device="cpu")
    assert "head_energy" not in two
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(two), tree_leaves(got)))


@pytest.mark.parametrize("energy", [False, True])
def test_mlp_forward_all_matches_reference(data, energy):
    feats = data[0]
    p = _ref_params(feats.shape[1], energy)
    want = R.mlp_forward_all(jax.tree.map(jax.numpy.asarray, p), feats.astype(np.float32))
    got = T.mlp_forward_all(T.params_from_reference(p, "cpu"),
                            torch.from_numpy(feats.astype(np.float32)))
    assert (got[2] is None) == (not energy) and (want[2] is None) == (not energy)
    for g, w in zip(got, want):
        if w is not None:
            w = np.asarray(w)
            assert np.max(np.abs(g.numpy() - w)) <= FWD_TOL * max(1.0, np.abs(w).max())
    lat, area = T.mlp_forward(T.params_from_reference(p, "cpu"),
                              torch.from_numpy(feats.astype(np.float32)))
    assert torch.equal(lat, got[0]) and torch.equal(area, got[1])


@pytest.mark.parametrize("energy", [False, True])
def test_train_matches_reference_from_its_init(data, energy, monkeypatch):
    feats, lat, area, en = data
    en = en if energy else None
    cfg = R.CostModelConfig(steps=50, batch=64, dropout=0.0)

    def ref_init(gen, in_dim, cfg, energy=False, device="cuda"):
        return T.params_from_reference(_ref_params(in_dim, energy, cfg.seed), device)

    monkeypatch.setattr(T, "init_mlp", ref_init)
    want, want_m = R.train(feats, lat, area, cfg, energy_mj=en)
    got, got_m = T.train(feats, lat, area, T.CostModelConfig(**dataclasses.asdict(cfg)),
                         energy_mj=en, device="cpu")
    assert np.array_equal(got.mu, want.mu) and np.array_equal(got.sigma, want.sigma)
    assert got.has_energy == want.has_energy == energy
    ref_leaves = tree_leaves(jax.tree.map(np.asarray, want.params))
    port_leaves = tree_leaves(got.params)  # the same (sorted) nesting as converted
    assert len(ref_leaves) == len(port_leaves)
    for g, w in zip(port_leaves, ref_leaves):
        assert np.max(np.abs(g.numpy() - w)) <= PARAM_TOL * max(1.0, np.abs(w).max())
    assert sorted(got_m) == sorted(want_m)
    for key, w in want_m.items():
        assert got_m[key] == pytest.approx(w, rel=METRIC_TOL), key
    # and the trained models predict alike
    pw, pg = want.predict_all(feats[:32]), got.predict_all(feats[:32])
    for key in ("latency_ms", "area_mm2") + (("energy_mj",) if energy else ()):
        np.testing.assert_allclose(pg[key], pw[key], rtol=METRIC_TOL)


def test_cost_model_learns():
    """The reference's own check (tests/test_core_nahas.py), on the port."""
    feats, lat, area = T.generate_dataset(nas.tiny_space(), has.has_space(), 900, seed=0)
    cfg = T.CostModelConfig(steps=2500, batch=64)
    model, metrics = T.train(feats, lat, area, cfg, device="cpu")
    assert metrics["val_latency_mape"] < 0.40, metrics
    assert metrics["val_area_mape"] < 0.25, metrics
    lat_p, area_p = model.predict(feats[:8])
    assert lat_p.shape == area_p.shape == (8,) and np.all(lat_p > 0) and np.all(area_p > 0)


@pytest.mark.parametrize("energy", [False, True])
def test_learned_backend_records_match_reference(data, energy):
    feats, lat, area, en = data
    cfg = R.CostModelConfig(steps=30, batch=64)
    ref_model, _ = R.train(feats, lat, area, cfg, energy_mj=en if energy else None)
    port_model = T.CostModel(
        params=T.params_from_reference(jax.tree.map(np.asarray, ref_model.params), "cpu"),
        mu=ref_model.mu, sigma=ref_model.sigma, feature_fn=lambda f: f)
    rng = np.random.default_rng(4)
    space_r, space_t = ref_nas.tiny_space(), nas.tiny_space()
    vecs = np.stack([np.concatenate([space_r.sample(rng), ref_has.has_space().sample(rng)])
                     for _ in range(64)])
    kw = dict(latency_target_ms=0.5, area_target_mm2=simulator.BASELINE_AREA_MM2,
              energy_target_mj=0.5 if energy else None)
    ref = ref_engine.EvaluationEngine(
        space_r, ref_has.has_space(), ref_proxy.SurrogateAccuracy(),
        ref_reward.RewardConfig(**kw),
        backend=RefLearned(ref_model, space_r, ref_has.has_space()))
    port = port_engine.EvaluationEngine(
        space_t, has.has_space(), proxy.SurrogateAccuracy(), reward.RewardConfig(**kw),
        backend=LearnedBackend(port_model, space_t, has.has_space()))
    want, got = ref.evaluate_batch(vecs), port.evaluate_batch(vecs)
    assert [r["valid"] for r in got] == [r["valid"] for r in want]
    assert sum(r["valid"] for r in want) >= 8
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for key, wv in w.items():
            if isinstance(wv, float) and key != "accuracy":
                assert g[key] == pytest.approx(wv, rel=RECORD_TOL), key
            else:
                assert g[key] == wv, key
