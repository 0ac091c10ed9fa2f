"""``scripts/torch_sweep.py`` on the CPU: a ``--quick`` sweep of
``paper-use-cases`` into a durable store prints the table of the library
call (``sweep.SweepRunner``); ``--resume`` replays it from the checkpoints,
evaluating nothing, to the same table; and the flags the port refuses
(``--snapshot``) are refused."""
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
    cli = _cli()
    for argv in (["--snapshot", str(tmp_path / "x.snap"), "--store", str(tmp_path / "s")],
                 ["--processes"]):
        with pytest.raises(SystemExit) as err:
            cli.main(["--device", "cpu", "--quick", *argv])
        assert err.value.code == 2
    assert "serve tier" in capsys.readouterr().err
