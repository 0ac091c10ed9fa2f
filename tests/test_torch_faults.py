"""The port's fault plans and checkpoints held against the reference:
``FaultPlan.parse``/``spec``/``sample`` bitwise for the same spec and seed
(stdlib ``random`` on both sides), the thread/process arming split, and the
``Checkpointer``'s sha256 footer (round trip, a corrupt file is missing and
counted, a footer-less file still loads, the two implementations read each
other's files)."""
import pickle

import pytest

pytest.importorskip("torch")

from repro.runtime import checkpoint as ref_checkpoint  # noqa: E402
from repro.runtime import faults as ref_faults  # noqa: E402
from repro_torch.runtime import checkpoint as port_checkpoint  # noqa: E402
from repro_torch.runtime import faults as port_faults  # noqa: E402

JOBS = [f"sweep.{s}" for s in ("lat-0.3ms", "edge-sku-nano", "energy-1mJ",
                                "lat-0.8ms", "lat-0.5ms-soft")]
SPECS = [
    "crash:sweep.a:0:1;hang:sweep.b:1:2;exc:sweep.c:2:1;"
    "slow:sweep.d:0:0.25;torn:sweep.e:1;ckpt:sweep.f:3",
    "crash:sweep.lat-0.5ms:0:1",
    "exc:j;crash:j;hang:j:2;slow:j:1:1e-3;torn:t;ckpt:c",
    " ; crash:sweep.x:0:0 ;; ",
    "",
]


def _events(plan) -> list[tuple]:
    return [(ev.kind, ev.target, ev.attempt, ev.admits, ev.arg) for ev in plan.events]


@pytest.mark.parametrize("spec", SPECS)
def test_parse_and_spec_equal_the_reference(spec):
    port, ref = port_faults.FaultPlan.parse(spec), ref_faults.FaultPlan.parse(spec)
    assert _events(port) == _events(ref)
    assert port.spec() == ref.spec()
    assert port_faults.FaultPlan.parse(port.spec()) == port  # round trip
    assert bool(port) == bool(ref)


@pytest.mark.parametrize("bad", ["meteor:sweep.a:0:0", "crash::0:0", "slow:sweep.a:0"])
def test_parse_refuses_what_the_reference_refuses(bad):
    with pytest.raises(ValueError) as ref_err:
        ref_faults.FaultPlan.parse(bad)
    with pytest.raises(ValueError) as port_err:
        port_faults.FaultPlan.parse(bad)
    assert str(port_err.value) == str(ref_err.value)


@pytest.mark.parametrize("seed", [0, 1, 7, 12345])
def test_sample_equals_the_reference_for_the_seed(seed):
    kw = dict(crashes=2, hangs=1, flaky=2, slow=2, torn=1, ckpt=1, admits=2)
    port = port_faults.FaultPlan.sample(JOBS, seed=seed, **kw)
    ref = ref_faults.FaultPlan.sample(JOBS, seed=seed, **kw)
    assert _events(port) == _events(ref)  # the slow sleeps too, to the bit
    assert port.spec() == ref.spec()
    # the spec prints a slow sleep to 6 digits (``:g``, as the reference's
    # does), so the exact round trip holds for plans without one
    no_slow = dict(kw, slow=0)
    plan = port_faults.FaultPlan.sample(JOBS, seed=seed, **no_slow)
    assert port_faults.FaultPlan.parse(plan.spec()) == plan
    assert _events(plan) == _events(ref_faults.FaultPlan.sample(JOBS, seed=seed, **no_slow))


def test_thread_mode_arms_no_crash_and_no_hang():
    plan = port_faults.FaultPlan.parse("crash:j:0:0;hang:j:0:0;exc:j:1:0;slow:j:0:0.1")
    assert {ev.kind for ev in plan.admit_events("j", 0, process=False)} == {"exc", "slow"}
    assert {ev.kind for ev in plan.admit_events("j", 0, process=True)} == {
        "crash", "hang", "exc", "slow"}
    assert not any(ev.kind == "exc" for ev in plan.admit_events("j", 1, process=True))
    ref = ref_faults.FaultPlan.parse(plan.spec())
    for attempt in (0, 1):
        for process in (False, True):
            assert _events(port_faults.FaultPlan(tuple(
                plan.admit_events("j", attempt, process)))) == _events(
                ref_faults.FaultPlan(tuple(ref.admit_events("j", attempt, process))))
    # the thread-mode injector hands back the runtime itself when nothing fires
    injector = port_faults.FaultInjector(port_faults.FaultPlan.parse("crash:j:0:0"),
                                         process=False)
    sentinel = object()
    assert injector.runtime(sentinel, "j", 0) is sentinel


def test_checkpoint_digest_round_trip(tmp_path):
    ck = port_checkpoint.Checkpointer(tmp_path)
    ck.save("t", {"x": 1, "arr": list(range(100))})
    assert ck.load("t") == {"x": 1, "arr": list(range(100))}
    assert (ck.saved, ck.loaded, ck.corrupt) == (1, 1, 0)
    # the same footer as the reference's: each side reads the other's files
    assert port_checkpoint._DIGEST_MAGIC == ref_checkpoint._DIGEST_MAGIC
    assert ref_checkpoint.Checkpointer(tmp_path).load("t") == {"x": 1,
                                                               "arr": list(range(100))}
    ref_checkpoint.Checkpointer(tmp_path).save("r", {"y": 2})
    assert ck.load("r") == {"y": 2}


def test_corrupt_checkpoint_is_missing_not_fatal(tmp_path):
    ck = port_checkpoint.Checkpointer(tmp_path)
    path = ck.save("t", {"x": 1})
    data = bytearray(path.read_bytes())
    data[len(data) // 2] ^= 0xFF  # bit rot in the payload
    path.write_bytes(bytes(data))
    assert ck.load("t") is None  # a cold restart, not an unpickling crash
    assert ck.corrupt == 1 and path.exists()
    # the injector's ckpt fault flips the same byte after the nth save
    inj = port_faults.FaultInjector(port_faults.FaultPlan.parse("ckpt:u:1"))
    wrapped = inj.checkpointer(port_checkpoint.Checkpointer(tmp_path / "inj"))
    wrapped.save("u", {"n": 0})
    assert wrapped.load("u") == {"n": 0}
    wrapped.save("u", {"n": 1})
    assert wrapped.load("u") is None and wrapped.corrupt == 1


def test_footerless_checkpoint_still_loads(tmp_path):
    ck = port_checkpoint.Checkpointer(tmp_path)
    ck._path("old").write_bytes(pickle.dumps({"x": 2}))
    assert ck.load("old") == {"x": 2} and ck.corrupt == 0
    bare = port_checkpoint.Checkpointer(tmp_path / "bare", digest=False)
    path = bare.save("t", {"x": 3})
    assert port_checkpoint._DIGEST_MAGIC not in path.read_bytes()
    assert bare.load("t") == {"x": 3}
