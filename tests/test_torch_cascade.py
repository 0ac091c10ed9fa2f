"""The port's cascade backend held against the JAX package's: one seeded
numpy stream of joint vectors replayed through each implementation's
``EvaluationEngine`` gives bitwise records and stage counters, with a
scenario set and with none; and the reference's own cascade checks
(tests/test_hw_backend.py) on the port."""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core import engine as ref_engine  # noqa: E402
from repro.core import has as ref_has  # noqa: E402
from repro.core import nas as ref_nas  # noqa: E402
from repro.core import proxy as ref_proxy  # noqa: E402
from repro.core import reward as ref_reward  # noqa: E402
from repro.core import simulator as ref_sim  # noqa: E402
from repro.hw import CascadeBackend as RefCascade  # noqa: E402
from repro_torch.core import engine as port_engine  # noqa: E402
from repro_torch.core import has, nas, proxy, reward, simulator  # noqa: E402
from repro_torch.core.engine import EvaluationEngine, RecordStore  # noqa: E402
from repro_torch.hw import CascadeBackend  # noqa: E402


def _rcfg(lib=reward, **kw):
    base = dict(latency_target_ms=0.5, area_target_mm2=simulator.BASELINE_AREA_MM2,
                energy_target_mj=0.5)
    base.update(kw)
    return lib.RewardConfig(**base)


def _joint_vecs(nspace, hspace, n, seed=0):
    rng = np.random.default_rng(seed)
    return np.stack([np.concatenate([nspace.sample(rng), hspace.sample(rng)])
                     for _ in range(n)])


@pytest.mark.parametrize("scenario_set", [["paper-use-cases"], ["edge-skus", "lat-0.3ms"], []])
def test_replayed_stream_gives_the_reference_records_and_stats(scenario_set):
    vecs = _joint_vecs(nas.tiny_space(), has.has_space(), 256, seed=21)
    # half of them on the baseline accelerator, so the refine stage sees many
    vecs[::2, nas.tiny_space().num_decisions:] = ref_has.baseline_vec(ref_has.has_space())
    ref_casc, port_casc = RefCascade(scenarios=scenario_set), CascadeBackend(scenarios=scenario_set)
    assert port_casc.cache_key() == ref_casc.cache_key()
    ref = ref_engine.EvaluationEngine(
        ref_nas.tiny_space(), ref_has.has_space(), ref_proxy.SurrogateAccuracy(),
        _rcfg(ref_reward, area_target_mm2=ref_sim.BASELINE_AREA_MM2), backend=ref_casc)
    port = port_engine.EvaluationEngine(
        nas.tiny_space(), has.has_space(), proxy.SurrogateAccuracy(), _rcfg(),
        backend=port_casc)
    for chunk in np.split(vecs, 4):  # incumbents carry from batch to batch
        assert port.evaluate_batch(chunk) == ref.evaluate_batch(chunk)
    assert port_casc.stats.as_dict() == ref_casc.stats.as_dict()
    st = port_casc.stats
    assert st.refined > 0 and st.dominance_pruned > 0
    assert (st.envelope_pruned > 0) == bool(scenario_set)
    # the only intended difference: the port's namespace carries its impl tag
    assert port._ns != ref._ns


def test_cascade_namespace_is_content_based():
    """Two cascade instances over the same scenario set share records;
    different scenario sets do not."""
    nspace, hspace = nas.tiny_space(), has.has_space()
    acc = proxy.CachedAccuracy(proxy.SurrogateAccuracy())
    store = RecordStore()
    vecs = _joint_vecs(nspace, hspace, 16, seed=3)
    c1 = CascadeBackend(scenarios=["lat-0.3ms"])
    c2 = CascadeBackend(scenarios=["lat-0.3ms"])
    c3 = CascadeBackend(scenarios=["lat-1.3ms"])
    assert c1.cache_key() == c2.cache_key()
    assert c1.cache_key() != c3.cache_key()
    e1 = EvaluationEngine(nspace, hspace, acc, _rcfg(), store=store, backend=c1)
    e1.evaluate_batch(vecs)
    e2 = EvaluationEngine(nspace, hspace, acc, _rcfg(), store=store, backend=c2)
    e2.evaluate_batch(vecs)
    assert e2.stats.evaluated == 0
    e3 = EvaluationEngine(nspace, hspace, acc, _rcfg(), store=store, backend=c3)
    e3.evaluate_batch(vecs)
    assert e3.stats.evaluated == 16


def test_cascade_reads_accuracy_lazily():
    """Only candidates that reach the dominance stage pay for an accuracy."""
    nspace, hspace = nas.tiny_space(), has.has_space()
    calls = []
    base = proxy.SurrogateAccuracy()

    def counting_acc(spec):
        calls.append(spec)
        return base(spec)

    casc = CascadeBackend(scenarios=["edge-sku-nano"])
    eng = EvaluationEngine(nspace, hspace, counting_acc, _rcfg(), cache=False, backend=casc)
    eng.evaluate_batch(_joint_vecs(nspace, hspace, 96, seed=10))
    cheap_pruned = casc.stats.static_invalid + casc.stats.envelope_pruned
    assert cheap_pruned > 0
    assert len(set(calls)) <= 96 - cheap_pruned


def test_cascade_refined_records_are_exact():
    """Survivors of the prefilter get the analytic backend's records."""
    nspace, hspace = nas.tiny_space(), has.has_space()
    acc = proxy.CachedAccuracy(proxy.SurrogateAccuracy())
    vecs = _joint_vecs(nspace, hspace, 64, seed=5)
    exact = EvaluationEngine(nspace, hspace, acc, _rcfg(), cache=False)
    casc = EvaluationEngine(nspace, hspace, acc, _rcfg(), cache=False,
                            backend=CascadeBackend(scenarios=["lat-0.3ms"]))
    refined = 0
    for re, rc in zip(exact.evaluate_batch(vecs), casc.evaluate_batch(vecs)):
        if rc["valid"]:
            assert rc == re
            refined += 1
    assert refined > 0


def test_cascade_stage_counters_add_up():
    nspace, hspace = nas.tiny_space(), has.has_space()
    acc = proxy.CachedAccuracy(proxy.SurrogateAccuracy())
    casc = CascadeBackend(scenarios=["edge-sku-nano"])
    eng = EvaluationEngine(nspace, hspace, acc, _rcfg(), cache=False, backend=casc)
    eng.evaluate_batch(_joint_vecs(nspace, hspace, 96, seed=6))
    st = casc.stats
    assert st.requested == 96
    assert st.requested == st.pruned + st.refined
    assert st.pruned > 0 and st.refined > 0
    assert st.as_dict()["prune_rate"] == pytest.approx(st.pruned / 96)


def test_cascade_without_scenarios_still_prunes_dominated():
    """No envelope: only static validity and dominance fire."""
    nspace, hspace = nas.tiny_space(), has.has_space()
    acc = proxy.CachedAccuracy(proxy.SurrogateAccuracy())
    casc = CascadeBackend()
    eng = EvaluationEngine(nspace, hspace, acc, _rcfg(), cache=False, backend=casc)
    rng = np.random.default_rng(8)
    for _ in range(4):
        eng.evaluate_batch(np.stack([
            np.concatenate([nspace.sample(rng), hspace.sample(rng)]) for _ in range(64)
        ]))
    assert casc.stats.envelope_pruned == 0
    assert casc.stats.dominance_pruned > 0
