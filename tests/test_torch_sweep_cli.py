"""``scripts/torch_sweep.py`` on the CPU: a ``--quick`` sweep of
``paper-use-cases`` into a durable store prints the table of the library
call (``sweep.SweepRunner``); ``--resume`` replays it from the checkpoints,
evaluating nothing, to the same table; ``--snapshot`` writes the serve
tier's snapshot of the finished store; and the flags it refuses as the
reference does are refused."""
import importlib.util
from pathlib import Path

import pytest

pytest.importorskip("torch")

from repro_torch.core import nas, proxy, sweep  # noqa: E402
from repro_torch.core.search import SearchConfig  # noqa: E402

SCRIPT = Path(__file__).resolve().parents[1] / "scripts" / "torch_sweep.py"


def _cli():
    spec = importlib.util.spec_from_file_location("torch_sweep", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _table_in(out: str, n_lines: int) -> list[str]:
    lines = out.splitlines()
    start = next(i for i, ln in enumerate(lines) if ln.startswith("scenario "))
    return lines[start:start + n_lines]


def test_store_then_resume_print_the_library_table(tmp_path, capsys):
    want = sweep.SweepRunner(
        "paper-use-cases", nas.tiny_space(), proxy.SurrogateAccuracy(),
        sweep.SweepConfig(search=SearchConfig(samples=96, batch=16, seed=0,
                                              controller="ppo", device="cpu")),
    ).run().table().splitlines()
    cli = _cli()
    store = str(tmp_path / "s.jsonl")
    cli.main(["--device", "cpu", "--quick", "--preset", "paper-use-cases",
              "--store", store])
    first = capsys.readouterr().out
    assert _table_in(first, len(want)) == want
    assert f"appended {sum(1 for _ in open(store))})" in first

    cli.main(["--device", "cpu", "--quick", "--preset", "paper-use-cases",
              "--store", store, "--resume"])
    again = capsys.readouterr().out
    # completed checkpoints replay: no lookup at all, so only the store line
    # (its counters) differs from the first run's table
    assert _table_in(again, len(want))[:-1] == want[:-1]
    assert "shared store: 0 evaluations for 0 lookups" in again
    assert "appended 0)" in again


def test_snapshot_and_processes_without_workers_are_refused(tmp_path, capsys):
    """``--store S --snapshot P`` writes the artifact ``snapshot_store``
    writes of the finished store; ``--snapshot`` without ``--store`` and
    ``--processes`` without ``--workers`` are refused."""
    from repro_torch.serve import snapshot_store

    cli = _cli()
    store, snap = str(tmp_path / "s.jsonl"), tmp_path / "s.snap"
    cli.main(["--device", "cpu", "--quick", "--scenarios", "lat-0.3ms,energy-0.7mJ",
              "--samples", "16", "--batch", "8", "--store", store, "--snapshot", str(snap)])
    header, _ = snapshot_store(store, tmp_path / "want.snap")
    assert f"snapshot: frontier {header['count']} -> {snap}" in capsys.readouterr().out
    assert snap.read_bytes() == (tmp_path / "want.snap").read_bytes()

    for argv, why in ((["--snapshot", str(tmp_path / "x.snap")], "--snapshot needs --store"),
                      (["--processes"], "--processes needs --workers")):
        with pytest.raises(SystemExit) as err:
            cli.main(["--device", "cpu", "--quick", *argv])
        assert err.value.code == 2
        assert why in capsys.readouterr().err
