"""The port's executor, on the CPU: serial, thread and process sweeps bitwise
equal with their stores in agreement; a killed worker healed in one
invocation, after which a rerun re-simulates nothing; a healed run with the
fault-free winners; a poison job quarantined; a hung worker killed by the
job deadline; the shared budget interrupting across processes, and a resume
finishing; the round-robin shard; an unpicklable job refused before any
worker spawns; a torn report message read as end-of-file, never waited on;
and the card map of ``devices_per_worker``.

Every test that spawns runs the executor in a daemon thread joined with a
deadline (``DEADLINE_S``): past it the test kills the pool's processes and
fails with the executor's state, so no hang can hold the suite. The
executors also get a short heartbeat timeout and a job deadline, two
workers, and one torch thread per worker."""
import multiprocessing
import os
import pickle
import threading

import pytest

pytest.importorskip("torch")

from repro_torch.core import engine as port_engine  # noqa: E402
from repro_torch.core import nas, proxy, sweep  # noqa: E402
from repro_torch.core.search import SearchConfig, SearchInterrupted  # noqa: E402
from repro_torch.runtime import (  # noqa: E402
    SELFKILL_ENV,
    Budget,
    Checkpointer,
    DurableRecordStore,
    SearchExecutor,
    WorkerCrashed,
    scenario_jobs,
)
from repro_torch.runtime import executor as executor_mod  # noqa: E402

SCENARIOS = ["lat-0.3ms", "edge-sku-nano", "energy-1mJ", "lat-0.8ms"]
NAMES = sorted(f"sweep.{s}" for s in SCENARIOS)
DEADLINE_S = 90.0  # per executor run, joined from the test thread
HEARTBEAT_TIMEOUT_S = 30.0
JOB_DEADLINE_S = 60.0


@pytest.fixture(autouse=True)
def _one_thread_per_worker(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # read at the workers' torch import
    monkeypatch.delenv("REPRO_FAULTS", raising=False)
    monkeypatch.delenv(SELFKILL_ENV, raising=False)


def _search_cfg():
    # the evolution controller: no torch update in the workers, so the
    # spawned runs stay short; the equivalence holds for any controller
    return SearchConfig(samples=16, batch=8, controller="evolution", device="cpu")


def _jobs():
    return scenario_jobs(SCENARIOS, nas.tiny_space(), proxy.SurrogateAccuracy(),
                         _search_cfg())


def _executor(root, processes=True, **kw):
    kw.setdefault("job_deadline_s", JOB_DEADLINE_S)
    return SearchExecutor(
        store=DurableRecordStore(root / "s.jsonl"),
        checkpoint=Checkpointer(root / "ck"),
        max_workers=2,
        processes=processes,
        heartbeat_timeout_s=HEARTBEAT_TIMEOUT_S,
        **kw,
    )


def _bounded(ex: SearchExecutor, jobs):
    """``ex.run(jobs)`` in a daemon thread, joined with ``DEADLINE_S``."""
    box: dict = {}

    def target():
        try:
            box["report"] = ex.run(jobs)
        except BaseException as e:  # noqa: BLE001 - re-raised below
            box["error"] = e

    th = threading.Thread(target=target, daemon=True)
    th.start()
    th.join(DEADLINE_S)
    if th.is_alive():
        pool = ex._pool
        state = {"alive": [p.pid for p in multiprocessing.active_children()]}
        if pool is not None:
            state.update(ready=sorted(pool.ready), ready_s=pool.ready_s,
                         exitcodes=[p.exitcode for p in pool.procs])
        for p in multiprocessing.active_children():
            p.kill()
        pytest.fail(f"the executor still ran after {DEADLINE_S}s: {state}")
    if "error" in box:
        raise box["error"]
    return box["report"]


def _histories(report) -> dict:
    return {n: o.result.history for n, o in report.outcomes.items() if o.result}


def _by_vec(store) -> dict:
    return {port_engine.split_key(k)[1]: raw for k, raw, _ in store.entries()}


@pytest.fixture(scope="module")
def serial():
    """The fault-free serial sweep every executor run is held against."""
    res = sweep.SweepRunner(SCENARIOS, nas.tiny_space(), proxy.SurrogateAccuracy(),
                            sweep.SweepConfig(search=_search_cfg())).run()
    return {f"sweep.{o.scenario.name}": o for o in res.outcomes}


def test_serial_thread_and_process_sweeps_are_bitwise_equal(tmp_path, serial):
    threads = _bounded(_executor(tmp_path / "t", processes=False), _jobs())
    procs = _bounded(_executor(tmp_path / "p"), _jobs())
    for report in (threads, procs):
        assert sorted(report.done) == NAMES
        for name, o in serial.items():
            assert report.outcomes[name].result.history == o.result.history  # bitwise
            assert report.outcomes[name].result.best_record == o.result.best_record
    assert procs.store_stats["workers"] == 2
    assert sorted(procs.ready_s) == [0, 1] and all(s[0] > 0 for s in procs.ready_s.values())
    assert procs.shards == {name: i % 2 for i, name in
                            enumerate(f"sweep.{s}" for s in SCENARIOS)}
    t_store = DurableRecordStore(tmp_path / "t" / "s.jsonl")
    p_store = DurableRecordStore(tmp_path / "p" / "s.jsonl")  # base + segments
    assert _by_vec(t_store) and _by_vec(p_store) == _by_vec(t_store)
    t_store.close()
    p_store.close()


def test_killed_worker_heals_in_one_invocation_then_rerun_resimulates_nothing(
        tmp_path, monkeypatch, serial):
    monkeypatch.setenv(SELFKILL_ENV, "1:1")  # worker 1 dies at its 2nd admission
    report = _bounded(_executor(tmp_path), _jobs())
    assert sorted(report.done) == NAMES and not report.quarantined
    rec = report.recovery
    assert rec["crashes"] >= 1 and rec["respawns"] >= 1 and rec["retries"] >= 1
    assert len(report.ready_s[1]) == 1 + rec["respawns"]  # every incarnation's ready
    monkeypatch.delenv(SELFKILL_ENV)
    again = _bounded(_executor(tmp_path), _jobs())
    assert again.store_stats["puts"] == 0 and again.store_stats["appended"] == 0
    assert again.recovery["crashes"] == 0
    for name in NAMES:
        assert again.outcomes[name].result.history == serial[name].result.history


def test_healed_run_has_the_fault_free_winners(tmp_path, serial):
    chaos = _bounded(_executor(
        tmp_path, faults="crash:sweep.edge-sku-nano:0:1;exc:sweep.lat-0.8ms:1:1"), _jobs())
    assert sorted(chaos.done) == NAMES
    assert chaos.recovery["retries"] >= 2 and chaos.recovery["crashes"] == 1
    assert _histories(chaos) == {n: o.result.history for n, o in serial.items()}


def test_poison_job_is_quarantined(tmp_path):
    victim = "sweep.lat-0.3ms"
    report = _bounded(_executor(
        tmp_path, faults=f"crash:{victim}:0:0;crash:{victim}:1:0", max_job_retries=1),
        _jobs())
    assert report.quarantined == [victim]
    assert isinstance(report.outcomes[victim].error, WorkerCrashed)
    assert report.outcomes[victim].attempts == 2
    assert sorted(report.done) == [n for n in NAMES if n != victim]
    assert report.recovery["quarantined"] == 1


def test_hung_worker_is_killed_by_the_job_deadline(tmp_path, serial):
    victim = "sweep.energy-1mJ"
    report = _bounded(_executor(tmp_path, faults=f"hang:{victim}:0:1",
                                job_deadline_s=3.0), _jobs())
    assert sorted(report.done) == NAMES
    assert report.recovery["deadline_kills"] == 1
    assert report.outcomes[victim].attempts == 2
    assert report.outcomes[victim].result.history == serial[victim].result.history


def test_shared_budget_interrupts_across_processes_and_a_resume_finishes(tmp_path, serial):
    budget = Budget(max_samples=24)  # < 4 scenarios x 16 samples
    report = _bounded(_executor(tmp_path, budget=budget), _jobs())
    assert report.interrupted
    for name in report.interrupted:
        assert isinstance(report.outcomes[name].error, (SearchInterrupted, WorkerCrashed))
    assert budget.granted >= 16 and budget.exhausted  # synced back from the workers
    done = _bounded(_executor(tmp_path), _jobs())
    assert sorted(done.done) == NAMES
    assert _histories(done) == {n: o.result.history for n, o in serial.items()}


def test_round_robin_shard_is_deterministic():
    assert SearchExecutor._shard(list(range(7)), 3) == [[0, 3, 6], [1, 4], [2, 5]]


def test_unpicklable_job_is_refused_before_any_worker_spawns(tmp_path):
    from repro_torch.core.space import Choice, Space

    space = Space([Choice("a", (0, 1))], decoder=lambda d: d, name="adhoc")
    ex = _executor(tmp_path)
    jobs = scenario_jobs(["lat-0.3ms"], space, proxy.SurrogateAccuracy(), _search_cfg())
    with pytest.raises(ValueError, match="provenance"):
        ex.run(jobs)
    assert ex._pool is None


def test_a_torn_report_is_end_of_file_not_a_wait():
    """A worker killed mid-send leaves part of a message in its own pipe:
    the parent reads the complete messages before it, then drops the pipe."""
    ctx = multiprocessing.get_context("spawn")
    r, w = ctx.Pipe(duplex=False)
    w.send(("hb", 0, None))
    blob = pickle.dumps(("done", "sweep.x", {"history": list(range(1000))}))
    os.write(w.fileno(), len(blob).to_bytes(4, "big") + blob[:10])  # torn
    w.close()
    pool = executor_mod._ProcessPool(
        procs=[], in_qs=[], out_conns=[r], cards=None, stop_event=None, go_event=None,
        budget_spec=None, store_path=None, k=1, t_spawn=0.0, ctx=ctx,
        checkpoint_root=None, checkpoint_every=1, fault_spec=None, heartbeat_s=None)
    assert pool.receive(1.0) == [("hb", 0, None)]
    assert pool.out_conns == [None]
    assert pool.receive(0.01) == []


def test_devices_per_worker_maps_cards_round_robin():
    cards = ["0", "1", "2", "3"]
    assert [executor_mod.worker_cards(k, 2, cards) for k in range(3)] == [
        ["0", "1"], ["2", "3"], ["0", "1"]]
    assert [executor_mod.worker_cards(k, 1, ["5"]) for k in range(2)] == [["5"], ["5"]]
    with pytest.raises(ValueError, match="needs 2 cards"):
        executor_mod.worker_cards(0, 2, ["0"])
    if not executor_mod.visible_cards():  # no card here: the pool refuses to spawn
        ex = SearchExecutor(processes=True, devices_per_worker=1, max_workers=1)
        with pytest.raises(ValueError, match="shows 0"):
            ex.run(_jobs()[:1])
