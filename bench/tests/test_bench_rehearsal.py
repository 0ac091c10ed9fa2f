"""Every cell end to end on the CPU at the SMOKE sizes, the port on its
kernels' plain versions: the result has the contract's keys, ``correct``
is true, and the numbers compared are printed last."""
import json

import pytest

from bench import harness
from bench.tests import smoke

CELLS = [c["name"] for c in harness.load_spec(smoke.ROOT)["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_rehearses_on_the_cpu(cell, tmp_path, capsys):
    result = smoke.run(cell, tmp_path, seconds=0.2)
    assert result["correct"] is True, result["checks"]
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(result)[-1] == "checks"
    assert result["attempted"] > 0 and result["failed"] == 0
    spec = harness.load_spec(smoke.ROOT)
    want = {m["name"] for m in harness.metrics_for(spec, cell, trace=False)}
    assert set(result["metrics"]) == want and "setup_s" in want
    harness.emit(result)
    out, err = capsys.readouterr()
    assert json.loads(out.strip().splitlines()[-1])["correct"] is True
    assert err.strip().splitlines()[-1].startswith("check ")


def test_metrics_of_each_cell_follow_benchmark_json():
    spec = harness.load_spec(smoke.ROOT)
    for cell in CELLS:
        e2e = {m["name"] for m in harness.metrics_for(spec, cell, trace=False)}
        layer = harness.metrics_for(spec, cell, trace=True)
        assert "setup_s" in e2e and len(e2e) >= 2 and layer
        assert all(m["moves"] in e2e for m in layer)
        for m in layer:
            harness.reader(m["name"])  # each has a reader
