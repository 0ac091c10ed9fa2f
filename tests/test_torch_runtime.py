"""The port's durable runtime and scenario sweep, on the CPU: the durable
store (round trip at the prior hit rate, a torn tail, compaction, worker
segments and log shipping), checkpoint/resume of the joint search (bitwise
against an uninterrupted run; a completed checkpoint replays with no
evaluation; a checkpoint of the reference is refused, H4), and a
``paper-use-cases`` sweep held against the reference's: the evolution
sweep's histories, winners and table bitwise, the PPO sweep's configs equal
with final logits within one Adam step (``LOGIT_TOL``), both durable logs' records equal by
decision vector, and ``plan_transfer`` bitwise on ``scenarios.grid()``. Each
reference result is computed once per module."""
import json

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core import nas as ref_nas  # noqa: E402
from repro.core import proxy as ref_proxy  # noqa: E402
from repro.core import scenarios as ref_scenarios  # noqa: E402
from repro.core import search as ref_search  # noqa: E402
from repro.core import sweep as ref_sweep  # noqa: E402
from repro.runtime import Budget as RefBudget  # noqa: E402
from repro.runtime import Checkpointer as RefCheckpointer  # noqa: E402
from repro.runtime import DurableRecordStore as RefStore  # noqa: E402
from repro.runtime import SearchRuntime as RefRuntime  # noqa: E402
from repro_torch.core import engine as port_engine  # noqa: E402
from repro_torch.core import has as port_has  # noqa: E402
from repro_torch.core import nas as port_nas  # noqa: E402
from repro_torch.core import proxy as port_proxy  # noqa: E402
from repro_torch.core import scenarios as port_scenarios  # noqa: E402
from repro_torch.core import search as port_search  # noqa: E402
from repro_torch.core import sweep as port_sweep  # noqa: E402
from repro_torch.runtime import (  # noqa: E402
    Budget,
    Checkpointer,
    DurableRecordStore,
    SearchRuntime,
)

# The PPO logits after the sweep's 3 updates (3 epochs each). Adam divides
# each gradient entry by its own running magnitude, so an entry that is
# small against its float32 rounding (a sum of cancelling terms, summed in
# each implementation's own order) still steps by up to lr, in a direction
# the rounding picks: such logits part by a fraction of one step (measured
# up to 1.19e-04 at lr 5e-4) where the rest agree within 1e-7. The limit is
# one Adam step; the sampled configs are equal, which the test asserts first.
LOGIT_TOL = 5e-4
PRESET = "paper-use-cases"
SC = port_scenarios.get("lat-0.3ms")


def _cfg(lib, controller, **kw):
    extra = {"device": "cpu"} if lib is port_search else {}
    return lib.SearchConfig(samples=24, batch=8, seed=0, controller=controller,
                            **extra, **kw)


def _joint_vecs(n, seed):
    rng = np.random.default_rng(seed)
    nspace, hspace = port_nas.tiny_space(), port_has.has_space()
    return np.stack([np.concatenate([nspace.sample(rng), hspace.sample(rng)])
                     for _ in range(n)])


def _engine(store):
    return port_engine.EvaluationEngine(
        port_nas.tiny_space(), port_has.has_space(), port_proxy.SurrogateAccuracy(),
        SC.reward_config(), store=store, label="t")


def _by_vec(store) -> dict:
    return {port_engine.split_key(k)[1]: raw for k, raw, _ in store.entries()}


# ---------------------------------------------------------------------------
# durable store
# ---------------------------------------------------------------------------


def test_store_round_trip_keeps_the_hit_rate(tmp_path):
    path = tmp_path / "s.jsonl"
    store = DurableRecordStore(path)
    vecs = _joint_vecs(24, seed=3)
    recs = _engine(store).evaluate_batch(vecs)
    assert store.stats.puts == 24  # no close(): every put is flushed

    store2 = DurableRecordStore(path)
    assert (store2.loaded, store2.loaded_dropped) == (24, 0)
    eng2 = _engine(store2)
    assert eng2.evaluate_batch(vecs) == recs  # bitwise
    assert eng2.stats.evaluated == 0 and store2.stats.hit_rate == 1.0
    store.close()
    store2.close()


def test_torn_tail_is_skipped_and_compact_keeps_the_records(tmp_path):
    path = tmp_path / "s.jsonl"
    store = DurableRecordStore(path)
    _engine(store).evaluate_batch(_joint_vecs(8, seed=1))
    key = b"n" * 20 + np.asarray([1, 2], np.int64).tobytes()
    for i in range(3):  # 3 appends, 1 live key: last write wins
        store.put(key, {"valid": True, "accuracy": float(i)}, writer="w")
    store.close()
    with open(path, "a") as f:
        f.write('{"k": "dead')  # a killed writer's torn append
    store2 = DurableRecordStore(path)
    assert (store2.loaded, store2.loaded_dropped) == (9, 1)
    before = _by_vec(store2)
    assert store2.compact() == 2 + 1  # the stale duplicates and the torn line
    with open(path) as f:
        assert len([json.loads(ln) for ln in f if ln.strip()]) == 9
    store2.close()
    store3 = DurableRecordStore(path)
    assert store3.loaded_dropped == 0 and _by_vec(store3) == before
    assert store3.get(key)["accuracy"] == 2.0
    assert port_engine.split_key(key) == (b"n" * 20, (1, 2))
    store3.close()


def test_segments_merge_and_refresh_ships_them(tmp_path):
    path = tmp_path / "s.jsonl"
    base = DurableRecordStore(path)
    k = [b"n" * 20 + np.int64(i).tobytes() for i in range(4)]
    base.put(k[0], {"accuracy": 0.0})
    w1 = DurableRecordStore(path, segment=1)
    w10 = DurableRecordStore(path, segment=10)
    assert w1.loaded == 1  # a segment writer loads base + every segment
    w1.put(k[1], {"accuracy": 1.0})
    w10.put(k[1], {"accuracy": 1.0})  # content-addressed: identical bytes
    w10.put(k[2], {"accuracy": 2.0})
    assert w1.write_path.name == "s.jsonl.worker-1"
    assert path.read_text().count("\n") == 1  # segment writers leave the base alone
    assert [p.name for p in base.segment_paths()] == ["s.jsonl.worker-1",
                                                      "s.jsonl.worker-10"]
    with open(w1.write_path, "a") as f:
        f.write('{"k":"' + k[3].hex() + '"')  # a live writer's in-flight append
    assert base.refresh() == 2 and base.get(k[2])["accuracy"] == 2.0
    assert base.get(k[3]) is None  # the torn tail waits for the next refresh
    with pytest.raises(RuntimeError, match="base store"):
        w1.compact()
    for s in (w1, w10):
        s.close()
    with open(path.with_name("s.jsonl.worker-1"), "a") as f:
        f.write(',"w":null,"r":{"accuracy":3.0}}\n')
    assert base.refresh() == 1 and base.get(k[3])["accuracy"] == 3.0
    base.compact()
    assert base.segment_paths() == []  # merged and retired
    merged = DurableRecordStore(path)
    assert sorted(_by_vec(merged)) == [(0,), (1,), (2,), (3,)]
    for s in (base, merged):
        s.close()


# ---------------------------------------------------------------------------
# checkpoint / resume
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("controller", ["ppo", "evolution"])
def test_resumed_joint_search_is_bitwise_the_uninterrupted_one(tmp_path, controller):
    space, acc = port_nas.tiny_space(), port_proxy.SurrogateAccuracy()
    cfg = _cfg(port_search, controller)
    ref = port_search.joint_search(space, acc, cfg=cfg, scenario=SC)

    rt = SearchRuntime(store=DurableRecordStore(tmp_path / "s.jsonl"),
                       checkpoint=Checkpointer(tmp_path / "ck"),
                       budget=Budget(max_samples=16))
    with pytest.raises(port_search.SearchInterrupted) as ei:
        port_search.joint_search(space, acc, cfg=cfg, scenario=SC, runtime=rt, tag="t")
    assert ei.value.samples_done == 16
    rt.store.close()

    rt2 = SearchRuntime.at(tmp_path / "ck", tmp_path / "s.jsonl")
    res = port_search.joint_search(space, acc, cfg=cfg, scenario=SC, runtime=rt2, tag="t")
    assert res.history == ref.history
    assert res.best_record == ref.best_record
    assert np.array_equal(res.best_vec, ref.best_vec)
    assert res.engine_stats["evaluated"] <= 8  # the first half came from the store
    rt2.store.close()


def test_completed_checkpoint_replays_with_no_evaluation(tmp_path):
    space, acc = port_nas.tiny_space(), port_proxy.SurrogateAccuracy()
    cfg = port_search.SearchConfig(samples=16, batch=8, seed=0, device="cpu")
    first = port_search.joint_search(space, acc, cfg=cfg, scenario=SC,
                                     checkpoint_dir=str(tmp_path), tag="t")
    again = port_search.joint_search(space, acc, cfg=cfg, scenario=SC,
                                     checkpoint_dir=str(tmp_path), tag="t")
    assert again.engine_stats["requested"] == 0  # a pure replay
    assert again.history == first.history
    with pytest.raises(ValueError, match="different search"):
        port_search.joint_search(space, acc, cfg=port_search.SearchConfig(
            samples=16, batch=8, seed=7, device="cpu"), scenario=SC,
            checkpoint_dir=str(tmp_path), tag="t")


@pytest.mark.parametrize("samples_done", [8, 16])
def test_a_reference_checkpoint_is_refused(tmp_path, samples_done):
    """H4: the reference writes no implementation tag, so the port refuses
    its checkpoints, mid-search or completed, naming the implementation."""
    rt = RefRuntime(checkpoint=RefCheckpointer(tmp_path),
                    budget=RefBudget(max_samples=samples_done))
    try:
        ref_search.joint_search(
            ref_nas.tiny_space(), ref_proxy.SurrogateAccuracy(),
            cfg=ref_search.SearchConfig(samples=16, batch=8, seed=0),
            scenario=ref_scenarios.get("lat-0.3ms"), runtime=rt, tag="t")
    except ref_search.SearchInterrupted:
        pass
    assert RefCheckpointer(tmp_path).load("t")["samples_done"] == samples_done
    with pytest.raises(ValueError, match="implementation 'repro") as err:
        port_search.joint_search(
            port_nas.tiny_space(), port_proxy.SurrogateAccuracy(),
            cfg=port_search.SearchConfig(samples=16, batch=8, seed=0, device="cpu"),
            scenario=SC, checkpoint_dir=str(tmp_path), tag="t")
    assert "repro_torch" in str(err.value)
    # and the port's own checkpoints carry the tag
    port_search.joint_search(
        port_nas.tiny_space(), port_proxy.SurrogateAccuracy(),
        cfg=port_search.SearchConfig(samples=8, batch=8, seed=0, device="cpu"),
        scenario=SC, checkpoint_dir=str(tmp_path / "port"), tag="t")
    assert Checkpointer(tmp_path / "port").load("t")["meta"]["impl"] == "repro_torch"


# ---------------------------------------------------------------------------
# the sweep against the reference's
# ---------------------------------------------------------------------------


def _sweep(lib, nas_lib, proxy_lib, runtime_cls, ck_cls, store_cls, search_lib,
           controller, root):
    runner = lib.SweepRunner(PRESET, nas_lib.tiny_space(), proxy_lib.SurrogateAccuracy(),
                             lib.SweepConfig(search=_cfg(search_lib, controller)))
    rt = runtime_cls(store=store_cls(root / "s.jsonl"), checkpoint=ck_cls(root / "ck"))
    res = runner.run(runtime=rt)
    rt.store.close()
    logits = {o.scenario.name: np.asarray(ck_cls(root / "ck").load(
        f"sweep.{o.scenario.name}")["controller"].get("logits", np.zeros(0)))
        for o in res.outcomes}
    return res, logits, store_cls(root / "s.jsonl")


@pytest.fixture(scope="module", params=["evolution", "ppo"])
def both_sweeps(request, tmp_path_factory):
    controller = request.param
    root = tmp_path_factory.mktemp(f"sweep-{controller}")
    ref = _sweep(ref_sweep, ref_nas, ref_proxy, RefRuntime, RefCheckpointer, RefStore,
                 ref_search, controller, root / "ref")
    port = _sweep(port_sweep, port_nas, port_proxy, SearchRuntime, Checkpointer,
                  DurableRecordStore, port_search, controller, root / "port")
    return controller, ref, port


def test_sweep_matches_the_reference(both_sweeps):
    controller, (ref, ref_logits, _), (port, port_logits, _) = both_sweeps
    assert [o.scenario.name for o in port.outcomes] == [o.scenario.name
                                                        for o in ref.outcomes]
    for r, p in zip(ref.outcomes, port.outcomes):
        assert [h["vec"] for h in p.result.history] == [h["vec"] for h in r.result.history]
        if controller == "evolution":
            assert p.result.history == r.result.history  # bitwise
            assert p.best == r.best and p.result.best_record == r.result.best_record
        else:
            err = float(np.max(np.abs(port_logits[p.scenario.name]
                                      - ref_logits[r.scenario.name])))
            assert err <= LOGIT_TOL, (p.scenario.name, err)
            assert p.best["vec"] == r.best["vec"]
    if controller == "evolution":
        assert port.table() == ref.table()
        assert port.frontier.records() == ref.frontier.records()


def test_durable_logs_hold_the_same_records_by_vector(both_sweeps):
    _, (_, _, ref_store), (_, _, port_store) = both_sweeps
    ref_by_vec = {port_engine.split_key(k)[1]: raw for k, raw, _ in ref_store.entries()}
    assert ref_by_vec and _by_vec(port_store) == ref_by_vec
    # the keys themselves differ: the port's namespace digest carries its tag
    assert not {k for k, _, _ in port_store.entries()} & {k for k, _, _ in
                                                          ref_store.entries()}
    ref_store.close()
    port_store.close()


def test_plan_transfer_is_bitwise_on_the_grid():
    port_grid = port_scenarios.grid()
    ref_grid = ref_scenarios.grid()
    for k in (None, 1, 5, 40):
        port = port_sweep.plan_transfer(port_grid, k=k)
        ref = ref_sweep.plan_transfer(ref_grid, k=k)
        assert port.medoids == ref.medoids and port.donors == ref.donors
