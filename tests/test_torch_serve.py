"""The port's serve tier (``repro_torch.serve``) and its CLI
(``scripts/torch_runtime_serve.py``) held against the reference's, case for
case with ``tests/test_serve.py``, on the same inputs:

* **snapshots** — a store log (torn tails included) compacts to the bytes
  the reference writes for the same log and path, each implementation loads
  the other's artifact to the same frontier, corruption is caught and
  foreign files refused;
* **queries** — ``FrontierServer.best`` equals the port's and the
  reference's ``brute_force_best`` on randomized frontiers and scenarios and
  on the fixture's registered scenarios; the cache, fold invalidation, the
  merge laws and the serializability of 4 threads querying and folding;
* **admission** (``device="cpu"``) — in-flight dedupe, the retry and
  ``exhausted`` rule, and a fold equal by decision vector to the
  reference controller's on the fixture, scenario and seed;
* **the CLI** — every case of ``tests/data/serve_fixture_golden.json``
  byte for byte through ``--store``, ``--snapshot`` and ``--compact-to``
  (in-process through ``main(argv)``; one case in a subprocess with ``jax``
  and ``repro`` blocked, which also checks ``evaluations=0``), the
  corrupt-snapshot fallback, and admission on the requested device;
* **a port-built fixture** — ``scripts/torch_make_serve_fixture.py``, the
  port's copy of ``scripts/make_serve_fixture.py``'s recipe, builds a store
  that holds the fixture's records by decision vector, under the port's own
  namespace.

The fixture's keys carry the reference's namespace digest, which the port
reads as data. Each reference result is computed once per module."""
import dataclasses
import functools
import importlib.util
import io
import json
import os
import subprocess
import sys
import tempfile
import threading
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core import nas as ref_nas  # noqa: E402
from repro.core import proxy as ref_proxy  # noqa: E402
from repro.core import scenarios as ref_scenarios  # noqa: E402
from repro.core.pareto import ParetoFrontier as RefFrontier  # noqa: E402
from repro.runtime import DurableRecordStore as RefStore  # noqa: E402
from repro import serve as ref_serve  # noqa: E402
from repro_torch.core import engine as port_engine  # noqa: E402
from repro_torch.core import has as port_has  # noqa: E402
from repro_torch.core import nas, proxy, scenarios  # noqa: E402
from repro_torch.core.pareto import ParetoFrontier  # noqa: E402
from repro_torch.runtime import DurableRecordStore  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    AdmissionConfig,
    AdmissionController,
    FrontierServer,
    brute_force_best,
    load_snapshot,
    load_store_frontier,
    snapshot_store,
    write_snapshot,
)
from repro_torch.serve import snapshot as port_snapshot  # noqa: E402
from tests._hypothesis_compat import given, settings, st  # noqa: E402
from tests.test_serve import _random_raw, _random_store_log  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FIXTURE = ROOT / "tests" / "data" / "serve_fixture.jsonl"
GOLDEN = json.loads((ROOT / "tests" / "data" / "serve_fixture_golden.json").read_text())
CASES = [pytest.param(c, id=c["name"]) for c in GOLDEN["cases"]]
SCRIPT = ROOT / "scripts" / "torch_runtime_serve.py"
MAKE_FIXTURE = ROOT / "scripts" / "make_serve_fixture.py"
PORT_MAKE_FIXTURE = ROOT / "scripts" / "torch_make_serve_fixture.py"


def _dumps(rec) -> str:
    return json.dumps(rec, default=str)


def _frontier_json(frontier) -> list[str]:
    return [_dumps(r) for r in frontier.records()]


def _scenario_pair(rng):
    """The same random scenario (``tests/test_serve.py``'s distribution) for
    both implementations: (port, reference)."""
    kw = {
        "name": "prop",
        "mode": "hard" if rng.random() < 0.5 else "soft",
        "area_target_mm2": float(rng.uniform(2.0, 90.0)),
    }
    if rng.random() < 0.5:
        kw["latency_target_ms"] = float(rng.uniform(0.005, 2.5))
    else:
        kw["energy_target_mj"] = float(rng.uniform(0.0005, 2.0))
    return scenarios.Scenario(**kw), ref_scenarios.Scenario(**kw)


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------------------
# the reference's side, once per module
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def logs(tmp_path_factory):
    """Store logs of ``test_serve.py``'s seeds (torn and not) and the
    reference's frontier and snapshot bytes of each, keyed (seed, torn)."""
    root = tmp_path_factory.mktemp("logs")
    out = {}
    for seed in range(4):
        for torn in (False, True):
            rng = np.random.default_rng(seed)
            log = root / f"s{seed}{'t' if torn else ''}.jsonl"
            _random_store_log(log, rng, n=int(rng.integers(1, 60)), torn=torn)
            frontier, info = ref_serve.load_store_frontier(log)
            ref_serve.snapshot_store(log, root / f"{log.stem}.ref.snap")
            out[seed, torn] = {
                "log": log,
                "frontier": _frontier_json(frontier),
                "info": info,
                "snap": root / f"{log.stem}.ref.snap",
            }
    return out


@functools.cache
def _ref_randomized(seed: int):
    """``test_server_best_matches_brute_force_randomized``'s inputs and the
    reference's brute-force answers."""
    rng = np.random.default_rng(seed)
    with tempfile.TemporaryDirectory() as tmp:
        log = Path(tmp) / "s.jsonl"
        _random_store_log(log, rng, n=80)
        frontier, _ = ref_serve.load_store_frontier(log)
        text = log.read_text()
    records = frontier.records()
    pairs = [_scenario_pair(rng) for _ in range(60)]
    want = [_dumps(ref_serve.brute_force_best(records, ref)) for _, ref in pairs]
    return text, [port for port, _ in pairs], want


@functools.cache
def _ref_fixture_answers() -> dict:
    records = ref_serve.FrontierServer.from_store(FIXTURE).records()
    return {name: _dumps(ref_serve.brute_force_best(records, ref_scenarios.get(name)))
            for name in ref_scenarios.names()}


# ---------------------------------------------------------------------------
# snapshot round trip, bytes, cross-tier loads
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("torn", [False, True])
def test_snapshot_roundtrip_bitwise_from_store_log(logs, tmp_path, seed, torn):
    """store log -> frontier -> snapshot -> load, records byte-identical and
    equal to the reference's; torn tails dropped as the reference drops them;
    the snapshot's bytes are the reference's for the same log and path."""
    ref = logs[seed, torn]
    frontier, info = load_store_frontier(ref["log"])
    assert info == ref["info"]
    assert info["dropped_lines"] == (1 if torn else 0)
    assert _frontier_json(frontier) == ref["frontier"]

    header, _ = snapshot_store(ref["log"], tmp_path / "s.snap")
    snap = load_snapshot(tmp_path / "s.snap", verify=True)
    assert header["count"] == len(frontier)
    assert _frontier_json(snap.frontier()) == ref["frontier"]
    assert snap.frontier().offered == frontier.offered
    assert snap.frontier().admitted == frontier.admitted
    assert (tmp_path / "s.snap").read_bytes() == ref["snap"].read_bytes()


def test_snapshot_bytes_deterministic(tmp_path):
    rng = np.random.default_rng(7)
    log = tmp_path / "s.jsonl"
    _random_store_log(log, rng, n=40)
    snapshot_store(log, tmp_path / "a.snap")
    snapshot_store(log, tmp_path / "b.snap")
    ref_serve.snapshot_store(log, tmp_path / "r.snap")
    assert (tmp_path / "a.snap").read_bytes() == (tmp_path / "b.snap").read_bytes()
    assert (tmp_path / "a.snap").read_bytes() == (tmp_path / "r.snap").read_bytes()


@pytest.mark.parametrize("seed", [0, 3])
def test_each_tier_loads_the_others_artifact(logs, tmp_path, seed):
    ref = logs[seed, True]
    snapshot_store(ref["log"], tmp_path / "port.snap")
    from_ref = load_snapshot(ref["snap"], verify=True)
    from_port = ref_serve.load_snapshot(tmp_path / "port.snap", verify=True)
    assert _frontier_json(from_ref.frontier()) == ref["frontier"]
    assert _frontier_json(from_port.frontier()) == ref["frontier"]
    assert from_ref.header == from_port.header
    assert (port_snapshot.MAGIC, port_snapshot.VERSION) == (
        ref_serve.snapshot.MAGIC, ref_serve.snapshot.VERSION)


def test_snapshot_verify_detects_corruption(tmp_path):
    rng = np.random.default_rng(11)
    log = tmp_path / "s.jsonl"
    _random_store_log(log, rng, n=20)
    snapshot_store(log, tmp_path / "s.snap")
    blob = bytearray((tmp_path / "s.snap").read_bytes())
    blob[-3] ^= 0xFF  # flip a payload bit
    (tmp_path / "s.snap").write_bytes(bytes(blob))
    with pytest.raises(ValueError, match="digest mismatch"):
        load_snapshot(tmp_path / "s.snap", verify=True)
    with pytest.raises(ValueError, match="digest mismatch"):
        ref_serve.load_snapshot(tmp_path / "s.snap", verify=True)


def test_snapshot_rejects_foreign_files(tmp_path):
    (tmp_path / "x.snap").write_text('{"not": "a snapshot"}\n')
    with pytest.raises(ValueError, match="not a repro-frontier-snapshot"):
        load_snapshot(tmp_path / "x.snap")


def test_snapshot_empty_frontier(tmp_path):
    write_snapshot(ParetoFrontier(), tmp_path / "e.snap")
    ref_serve.write_snapshot(RefFrontier(), tmp_path / "r.snap")
    snap = load_snapshot(tmp_path / "e.snap", verify=True)
    assert len(snap) == 0 and snap.frontier().records() == []
    assert (tmp_path / "e.snap").read_bytes() == (tmp_path / "r.snap").read_bytes()


@given(st.data())
@settings(max_examples=40, deadline=None)
def test_snapshot_roundtrip_property(data):
    seed = data.draw(st.integers(0, 2**31 - 1))
    rng = np.random.default_rng(seed)
    with tempfile.TemporaryDirectory() as tmp:
        log = Path(tmp) / "h.jsonl"
        _random_store_log(
            log, rng, n=data.draw(st.integers(1, 50)), torn=data.draw(st.booleans())
        )
        frontier, _ = load_store_frontier(log)
        want, _ = ref_serve.load_store_frontier(log)
        snapshot_store(log, Path(tmp) / "h.snap")
        snap = load_snapshot(Path(tmp) / "h.snap", verify=True)
        assert _frontier_json(snap.frontier()) == _frontier_json(want)
        assert _frontier_json(frontier) == _frontier_json(want)


def test_load_store_frontier_imports_no_reference(tmp_path):
    """``load_store_frontier`` imports the store lazily: called with ``jax``
    and ``repro`` blocked, it reads the port's store and the fixture."""
    probe = (
        "import sys; sys.modules['jax'] = None; sys.modules['repro'] = None\n"
        "from repro_torch.serve import load_store_frontier, snapshot_store\n"
        f"f, info = load_store_frontier({str(FIXTURE)!r})\n"
        f"snapshot_store({str(FIXTURE)!r}, {str(tmp_path / 'fx.snap')!r})\n"
        "leaked = [n for n, m in sys.modules.items() if m is not None"
        " and (n == 'jax' or n.startswith(('jax.', 'repro.')))]\n"
        "print(len(f), info['namespaces'], leaked)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", probe], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[-1] == "[]"
    assert "e2cbc3e8d3a3" in out.stdout


# ---------------------------------------------------------------------------
# FrontierServer.best == brute force (the port's and the reference's)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4, 5])
def test_server_best_matches_brute_force_randomized(tmp_path, seed):
    text, queries, want = _ref_randomized(seed)
    (tmp_path / "s.jsonl").write_text(text)
    frontier, _ = load_store_frontier(tmp_path / "s.jsonl")
    server = FrontierServer(frontier)
    records = frontier.records()
    for sc, ref in zip(queries, want):
        got = _dumps(server.best(sc))
        assert got == _dumps(brute_force_best(records, sc))
        assert got == ref


def test_server_best_matches_brute_force_on_fixture_presets():
    server = FrontierServer.from_store(FIXTURE)
    records = server.records()
    want = _ref_fixture_answers()
    for name in scenarios.names():
        sc = scenarios.get(name)
        got = _dumps(server.best(sc))
        assert got == _dumps(brute_force_best(records, sc))
        assert got == want[name]


def test_server_cache_hits_and_copies():
    server = FrontierServer.from_store(FIXTURE)
    sc = scenarios.get("lat-0.3ms")
    a = server.best(sc)
    a["accuracy"] = -1.0  # caller mutation must not poison the cache
    b = server.best(sc)
    assert b["accuracy"] != -1.0
    assert server.stats.cache_hits == 1
    assert server.stats.evaluations == 0  # the serve tier never simulates
    assert server.cache_info() == {"size": 1, "cap": 4096, "hits": 1, "misses": 1}


def test_server_fold_invalidates_cache():
    server = FrontierServer.from_store(FIXTURE)
    sc = scenarios.Scenario(name="q", latency_target_ms=5.0, area_target_mm2=1e9)
    before = server.best(sc)
    better = dict(
        before, accuracy=before["accuracy"] + 0.5, latency_ms=4.9, vec=(9, 9, 9)
    )
    assert server.fold([better]) == 1
    assert server.version == 1
    assert server.best(sc)["accuracy"] == pytest.approx(better["accuracy"])


@given(st.data())
@settings(max_examples=40, deadline=None)
def test_server_best_property(data):
    seed = data.draw(st.integers(0, 2**31 - 1))
    rng = np.random.default_rng(seed)
    with tempfile.TemporaryDirectory() as tmp:
        log = Path(tmp) / "h.jsonl"
        _random_store_log(log, rng, n=data.draw(st.integers(1, 60)))
        frontier, _ = load_store_frontier(log)
        ref_records = ref_serve.load_store_frontier(log)[0].records()
        server = FrontierServer(frontier)
        for _ in range(8):
            sc, ref = _scenario_pair(rng)
            got = _dumps(server.best(sc))
            assert got == _dumps(brute_force_best(frontier.records(), sc))
            assert got == _dumps(ref_serve.brute_force_best(ref_records, ref))


# ---------------------------------------------------------------------------
# merge laws (the port's ParetoFrontier, and the reference's fold)
# ---------------------------------------------------------------------------


def _fold(records, cls=ParetoFrontier):
    f = cls()
    f.add_many(records)
    return f


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_frontier_merge_order_independent(seed):
    rng = np.random.default_rng(seed)
    records = [_random_raw(rng) for _ in range(50)]
    for i in range(0, 40, 7):  # metric ties with distinct payloads
        records.append(dict(records[i], paid_by=f"tie{i}"))
    b = records[:]
    rng.shuffle(b)
    assert _frontier_json(_fold(records)) == _frontier_json(_fold(b))
    assert _frontier_json(_fold(records)) == _frontier_json(_fold(records, RefFrontier))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_frontier_merge_commutative_and_idempotent(seed):
    rng = np.random.default_rng(seed)
    xs = [_random_raw(rng) for _ in range(30)]
    ys = [_random_raw(rng) for _ in range(30)]
    ab = _fold(xs)
    ab.merge(_fold(ys))
    ba = _fold(ys)
    ba.merge(_fold(xs))
    assert _frontier_json(ab) == _frontier_json(ba)
    again = _fold(xs + ys)
    again.merge(ab)  # merging a frontier into its own fold: no-op
    assert _frontier_json(again) == _frontier_json(ab)
    server = FrontierServer(_fold(xs))
    server.merge_frontier(_fold(ys))
    assert [_dumps(r) for r in server.records()] == _frontier_json(ab)


@given(st.integers(0, 2**31 - 1), st.integers(2, 40))
@settings(max_examples=40, deadline=None)
def test_frontier_merge_property(seed, n):
    rng = np.random.default_rng(seed)
    records = [_random_raw(rng) for _ in range(n)]
    shuffled = records[:]
    rng.shuffle(shuffled)
    assert _frontier_json(_fold(records)) == _frontier_json(_fold(shuffled))


# ---------------------------------------------------------------------------
# concurrency: queries under concurrent folds
# ---------------------------------------------------------------------------


def test_concurrent_queries_and_folds_are_serializable():
    """2 query threads + 2 fold threads; every answer equals the brute-force
    best over the frontier at SOME fold generation the query overlapped."""
    base_frontier, _ = load_store_frontier(FIXTURE)
    server = FrontierServer(base_frontier)
    base_records = server.records()

    def batch(k):
        return [
            {
                "valid": True,
                "accuracy": 0.9 + k * 1e-4 + j * 1e-6,
                "latency_ms": 10.0 + k + 0.1 * j,
                "energy_mj": 5.0 + k,
                "area_mm2": 50.0 + j,
                "vec": (k, j),
            }
            for j in range(3)
        ]

    fold_log: list = []
    fold_log_lock = threading.Lock()
    answers: list = []
    answers_lock = threading.Lock()
    stop = threading.Event()
    switch = sys.getswitchinterval()

    def folder(tid):
        for k in range(tid * 100, tid * 100 + 8):
            b = batch(k)
            with fold_log_lock:  # commit order == version order
                server.fold(b)
                fold_log.append((server.version, b))

    def querier(tid):
        rng = np.random.default_rng(tid)
        while not stop.is_set():
            sc, _ = _scenario_pair(rng)
            v0 = server.version
            got = _dumps(server.best(sc))
            v1 = server.version
            with answers_lock:
                answers.append((sc, got, v0, v1))

    folders = [threading.Thread(target=folder, args=(t,)) for t in (1, 2)]
    queriers = [threading.Thread(target=querier, args=(t,)) for t in (3, 4)]
    sys.setswitchinterval(1e-5)
    try:
        for t in queriers + folders:
            t.start()
        for t in folders:
            t.join(timeout=60)
        stop.set()
        for t in queriers:
            t.join(timeout=60)
    finally:
        stop.set()
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in folders + queriers)

    assert len(fold_log) == 16
    versions = [v for v, _ in fold_log]
    assert versions == sorted(versions)

    states = {0: base_records}
    f = _fold(base_records)
    for v, b in fold_log:
        f.add_many(b)
        states[v] = f.records()

    assert len(answers) > 0
    for sc, got, v0, v1 in answers:
        want = {_dumps(brute_force_best(states[v], sc)) for v in range(v0, v1 + 1)}
        assert got in want, f"{sc.describe()}: {got} not in {want}"


# ---------------------------------------------------------------------------
# admission, on the CPU
# ---------------------------------------------------------------------------


def test_concurrent_admission_dedupes_inflight(tmp_path):
    """Concurrent uncovered queries for the same envelope share one budgeted
    background search; the fold lands in the live frontier."""
    server = FrontierServer.from_store(FIXTURE)
    ctl = AdmissionController(
        server,
        nas.tiny_space(),
        proxy.SurrogateAccuracy(),
        AdmissionConfig(budget_samples=16, batch=8, max_concurrent=2, device="cpu"),
        store=DurableRecordStore(tmp_path / "adm.jsonl"),
    )
    covered = ctl.query(scenarios.get("lat-1.3ms"))
    assert covered.status == "served" and covered.answer["feasible"]
    assert ctl.admitted == 0

    sc = scenarios.Scenario(name="impossible", latency_target_ms=1e-9, area_target_mm2=0.5)
    results = [None, None]

    def ask(i):
        results[i] = ctl.query(sc)

    ts = [threading.Thread(target=ask, args=(i,)) for i in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in ts)
    assert {r.status for r in results} == {"searching"}
    assert ctl.admitted == 1
    ctl.close()

    final = ctl.query(sc)
    assert final.status == "exhausted"
    assert ctl.admitted == 1
    assert server.stats.folds >= 1


def _uncovered():
    # nothing on an empty frontier is feasible: always admits a search
    return {"name": "tight", "latency_target_ms": 0.5, "area_target_mm2": 40.0}


def _controller(**cfg_kw):
    return AdmissionController(
        FrontierServer(), nas.tiny_space(), proxy.SurrogateAccuracy(),
        AdmissionConfig(budget_samples=16, batch=8, device="cpu", **cfg_kw),
    )


def test_admission_retries_transient_search_failure(monkeypatch):
    ctl = _controller(max_attempts=3)
    real = ctl._run_search
    calls = {"n": 0}

    def flaky(scenario):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("injected store outage")
        return real(scenario)

    monkeypatch.setattr(ctl, "_run_search", flaky)
    sc = scenarios.Scenario(**_uncovered())
    first = ctl.query(sc, wait=True)
    assert first.status == "searching"
    assert ctl.failed == 1 and ctl.admitted == 1
    second = ctl.query(sc, wait=True)  # the retry runs the real search
    assert calls["n"] == 2 and ctl.admitted == 2
    assert second.status == "searching"
    third = ctl.query(sc)  # success retired the scenario
    assert third.status in ("served", "exhausted")
    assert ctl.admitted == 2
    ctl.close()


def test_admission_exhausts_after_max_attempts(monkeypatch):
    ctl = _controller(max_attempts=2)

    def always_down(scenario):
        raise RuntimeError("injected permanent outage")

    monkeypatch.setattr(ctl, "_run_search", always_down)
    sc = scenarios.Scenario(**_uncovered())
    first = ctl.query(sc, wait=True)
    assert first.status == "searching" and ctl.failed == 1
    second = ctl.query(sc, wait=True)
    assert second.status == "exhausted" and ctl.failed == 2
    third = ctl.query(sc)
    assert third.status == "exhausted" and ctl.admitted == 2
    ctl.close()


def _spy_folds(server) -> list:
    """Record what ``server.fold`` is offered (an admitted search's
    frontier), then fold it."""
    offered = []
    real = server.fold

    def fold(records):
        offered.append(list(records))
        return real(offered[-1])

    server.fold = fold
    return offered


# an envelope below the fixture's least latency (0.0085925 ms): uncovered
UNCOVERED = {"name": "below-frontier", "latency_target_ms": 0.005, "area_target_mm2": 40.0}


@functools.cache
def _ref_admission_fold(controller: str) -> list:
    server = ref_serve.FrontierServer.from_store(FIXTURE)
    offered = _spy_folds(server)
    ctl = ref_serve.AdmissionController(
        server, ref_nas.tiny_space(), ref_proxy.SurrogateAccuracy(),
        ref_serve.AdmissionConfig(budget_samples=16, batch=8, controller=controller),
    )
    adm = ctl.query(ref_scenarios.Scenario(**UNCOVERED), wait=True)
    ctl.close()
    return [offered, server.records(), adm.answer, ctl.admitted]


def _by_vec(records) -> list:
    """Records by decision vector, the namespace digest left out (each
    implementation's searches write their own)."""
    return sorted(_dumps({k: v for k, v in r.items() if k != "ns"}) for r in records)


@pytest.mark.parametrize("controller", ["reinforce", "evolution"])
def test_admission_fold_equals_the_reference_by_vector(controller):
    """A query below the fixture's frontier admits one search (seed 0): the
    search's frontier offered to the fold, the folded frontier and the final
    answer are the reference's by vector."""
    want_offered, want_records, want_answer, want_admitted = _ref_admission_fold(controller)
    server = FrontierServer.from_store(FIXTURE)
    offered = _spy_folds(server)
    ctl = AdmissionController(
        server, nas.tiny_space(), proxy.SurrogateAccuracy(),
        AdmissionConfig(budget_samples=16, batch=8, controller=controller, device="cpu"),
    )
    adm = ctl.query(scenarios.Scenario(**UNCOVERED), wait=True)
    ctl.close()
    assert ctl.admitted == want_admitted == 1
    assert server.stats.folds == 1
    assert len(offered) == len(want_offered) == 1 and offered[0]
    assert _by_vec(offered[0]) == _by_vec(want_offered[0])
    assert _by_vec(server.records()) == _by_vec(want_records)
    assert _by_vec([adm.answer["best"]]) == _by_vec([want_answer["best"]])
    assert adm.answer["feasible"] is want_answer["feasible"] is False


# ---------------------------------------------------------------------------
# the CLI: the reference's goldens byte for byte
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def cli():
    return _load(SCRIPT, "torch_runtime_serve")


@pytest.fixture(scope="module")
def fixture_snap(tmp_path_factory):
    path = tmp_path_factory.mktemp("snap") / "fx.snap"
    snapshot_store(FIXTURE, path)
    return path


def _run(cli, argv, stdin, capsys, monkeypatch):
    monkeypatch.setattr(sys, "stdin", io.StringIO(stdin))
    cli.main(argv)
    return capsys.readouterr()


@pytest.mark.parametrize("case", CASES)
def test_cli_store_answers_match_pre_pr_goldens(cli, case, capsys, monkeypatch):
    out = _run(cli, ["--store", str(FIXTURE)] + case["args"], case["stdin"], capsys,
               monkeypatch)
    assert out.out == case["stdout"]
    assert "evaluations=0" in out.err


@pytest.mark.parametrize("case", CASES)
def test_cli_snapshot_answers_match_pre_pr_goldens(cli, fixture_snap, case, capsys,
                                                   monkeypatch):
    out = _run(cli, ["--snapshot", str(fixture_snap)] + case["args"], case["stdin"],
               capsys, monkeypatch)
    assert out.out == case["stdout"]
    assert "verified)" in out.err


@pytest.mark.parametrize("case", CASES)
def test_cli_compact_to_answers_match_pre_pr_goldens(cli, tmp_path, case, capsys,
                                                     monkeypatch):
    snap = tmp_path / "fx.snap"
    out = _run(cli, ["--store", str(FIXTURE), "--compact-to", str(snap)] + case["args"],
               case["stdin"], capsys, monkeypatch)
    assert out.out == case["stdout"]
    assert "# compacted" in out.err
    ref_serve.snapshot_store(FIXTURE, tmp_path / "ref.snap")
    assert snap.read_bytes() == (tmp_path / "ref.snap").read_bytes()


def test_cli_serves_the_references_snapshot(cli, tmp_path, capsys, monkeypatch):
    ref_serve.snapshot_store(FIXTURE, tmp_path / "ref.snap")
    case = next(c for c in GOLDEN["cases"] if c["name"] == "all_json")
    out = _run(cli, ["--snapshot", str(tmp_path / "ref.snap")] + case["args"], "", capsys,
               monkeypatch)
    assert out.out == case["stdout"]


def test_cli_subprocess_without_jax_or_reference():
    """One golden case in a fresh interpreter with ``jax`` and ``repro``
    blocked: the same stdout, and ``evaluations=0`` on stderr."""
    case = next(c for c in GOLDEN["cases"] if c["name"] == "serve_stdin")
    argv = [str(SCRIPT), "--store", str(FIXTURE)] + case["args"]
    probe = ("import runpy, sys; sys.modules['jax'] = None; sys.modules['repro'] = None; "
             f"sys.argv = {argv!r}; runpy.run_path({str(SCRIPT)!r}, run_name='__main__')")
    out = subprocess.run([sys.executable, "-c", probe], input=case["stdin"], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout == case["stdout"]
    assert "evaluations=0" in out.stderr


def test_cli_requires_a_source(cli, capsys):
    with pytest.raises(SystemExit) as err:
        cli.main(["--all"])
    assert err.value.code == 2
    assert "--store and/or --snapshot" in capsys.readouterr().err


def test_cli_serve_loop_reports_bad_queries_and_continues(cli, capsys, monkeypatch):
    out = _run(cli, ["--store", str(FIXTURE), "--serve", "--json"],
               "no-such-scenario\nlat=bogus\nlat-0.8ms\n", capsys, monkeypatch)
    lines = [json.loads(ln) for ln in out.out.splitlines() if ln.strip()]
    assert len(lines) == 1 and lines[0]["scenario"] == "lat-0.8ms"
    assert out.err.count("error:") == 2


def test_cli_falls_back_to_log_replay_on_corrupt_snapshot(cli, tmp_path, capsys,
                                                          monkeypatch):
    snap = tmp_path / "s.snap"
    snapshot_store(FIXTURE, snap)
    data = bytearray(snap.read_bytes())
    data[-10] ^= 0xFF
    snap.write_bytes(bytes(data))
    with pytest.raises(SystemExit, match="failed verification"):
        _run(cli, ["--snapshot", str(snap), "--all"], "", capsys, monkeypatch)
    case = next(c for c in GOLDEN["cases"] if c["name"] == "all_json")
    out = _run(cli, ["--snapshot", str(snap), "--store", str(FIXTURE)] + case["args"], "",
               capsys, monkeypatch)
    assert "falling back" in out.err
    assert out.out == case["stdout"]


def test_cli_admits_on_the_requested_device(cli, capsys, monkeypatch):
    """``--budget-samples`` turns an uncovered query into an admitted search
    over ``--space`` with its controller on ``--device``."""
    seen = {}
    real = AdmissionConfig.search_config

    def spy(self):
        seen["device"] = self.device
        return real(self)

    monkeypatch.setattr(AdmissionConfig, "search_config", spy)
    out = _run(cli, ["--store", str(FIXTURE), "--budget-samples", "8", "--device", "cpu",
                     "--query", "lat=0.001,area=1", "--json"], "", capsys, monkeypatch)
    assert seen == {"device": "cpu"}
    assert "admitted=1" in out.err and "evaluations=0" in out.err
    assert json.loads(out.out)["scenario"] == "query(lat=0.001,area=1)"


# ---------------------------------------------------------------------------
# a port-built fixture, and the admission config
# ---------------------------------------------------------------------------


@functools.cache
def _fixture_recipe():
    return _load(MAKE_FIXTURE, "make_serve_fixture")


def test_port_built_store_holds_the_fixtures_records_by_vector(tmp_path, capsys):
    """``scripts/torch_make_serve_fixture.py``'s ``build`` with the
    reference script's recipe (tiny space, surrogate, seed 0): the records
    by decision vector are the fixture's, under the port's own namespace
    digest."""
    recipe, port_recipe = _fixture_recipe(), _load(PORT_MAKE_FIXTURE,
                                                    "torch_make_serve_fixture")
    for name in ("SCENARIOS", "SAMPLES", "BATCH", "SEED"):
        assert getattr(port_recipe, name) == getattr(recipe, name), name
    path = tmp_path / "port.jsonl"
    built = port_recipe.build(path, device="cpu")
    assert capsys.readouterr().out.startswith(f"{path}: {len(built)} records (")

    def by_vec(store):
        return {port_engine.split_key(k)[1]: raw for k, raw, _ in store.entries()}

    port = DurableRecordStore(path, read_only=True)
    fixture = RefStore(FIXTURE, read_only=True)
    assert by_vec(port) == by_vec(fixture)
    eng = port_engine.EvaluationEngine(
        nas.tiny_space(), port_has.has_space(), proxy.SurrogateAccuracy(),
        scenarios.get("lat-0.3ms").reward_config())
    _, info = load_store_frontier(path)
    _, fixture_info = load_store_frontier(FIXTURE)
    assert info["namespaces"] == [eng._ns.hex()[:12]]
    assert info["namespaces"] != fixture_info["namespaces"]


def test_admission_config_is_a_copy_plus_device():
    port = {f.name: f.default for f in dataclasses.fields(AdmissionConfig)}
    ref = {f.name: f.default for f in dataclasses.fields(ref_serve.AdmissionConfig)}
    assert port.pop("device") == "cuda"
    assert port == ref
    assert AdmissionConfig(device="cpu").search_config().device == "cpu"
