"""The port's run reports (``repro_torch.obs.report``) through the
reference's cases: trace merge and validation, a torn segment tail, broken
traces, and the built and rendered report, whose text must equal the
reference's on the same trace and metrics file."""
import json

import pytest

pytest.importorskip("torch")

from repro.obs import report as ref_report  # noqa: E402
from repro_torch.obs import report, trace  # noqa: E402


def _write_two_segment_trace(d):
    trace.start(d)
    with trace.span("simulate_batch", n=8, label="lat-0.3ms"):
        pass
    with trace.span("job", job="sweep.lat-0.3ms") as sp:
        sp.set(status="done")
    trace.stop()
    trace.start(d, worker=1)
    with trace.span("simulate_batch", n=4, label="lat-0.8ms"):
        pass
    trace.stop()


def test_trace_merge_validate_roundtrip(tmp_path):
    _write_two_segment_trace(tmp_path)
    assert [p.name for p in trace.trace_paths(tmp_path)] == [
        "trace.jsonl", "trace.jsonl.worker-1"]
    merged = trace.merge(tmp_path)
    info = report.validate_chrome_trace(merged)
    assert info == ref_report.validate_chrome_trace(merged)
    assert info["tracks"] == 2
    assert {"simulate_batch", "job"} <= set(info["names"])
    payload = json.loads(merged.read_text())
    procs = {ev["args"]["name"] for ev in payload["traceEvents"]
             if ev.get("ph") == "M" and ev["name"] == "process_name"}
    assert procs == {"main", "worker-1"}
    jobs = [ev for ev in payload["traceEvents"] if ev.get("name") == "job"]
    assert jobs[0]["args"] == {"job": "sweep.lat-0.3ms", "status": "done"}


def test_merge_tolerates_torn_segment_tail(tmp_path):
    _write_two_segment_trace(tmp_path)
    with open(tmp_path / "trace.jsonl.worker-1", "a") as f:
        f.write('{"name": "torn')  # killed writer mid-append
    info = report.validate_chrome_trace(trace.merge(tmp_path))
    assert info["spans"] == 3


@pytest.mark.parametrize("events,match", [
    ([], "missing or empty"),
    ([{"name": "a", "ph": "X", "ts": 5.0, "dur": 1, "pid": 0, "tid": 0},
      {"name": "b", "ph": "X", "ts": 2.0, "dur": 1, "pid": 0, "tid": 0}], "precedes"),
    ([{"name": "a", "ph": "X", "ts": 1.0, "pid": 0}], "missing 'tid'"),
    ([{"name": "a", "ph": "X", "ts": 1.0, "dur": -2, "pid": 0, "tid": 0}], "bad dur"),
])
def test_validator_rejects_broken_traces(tmp_path, events, match):
    bad = tmp_path / "t.json"
    bad.write_text(json.dumps({"traceEvents": events}))
    with pytest.raises(ValueError, match=match):
        report.validate_chrome_trace(bad)
    with pytest.raises(ValueError, match=match):
        ref_report.validate_chrome_trace(bad)


def test_report_build_and_render_equal_the_references(tmp_path):
    _write_two_segment_trace(tmp_path)
    report.write_metrics(
        tmp_path, extra={"namespaces": {"abcd": {"gets": 4, "hits": 2, "hit_rate": 0.5}}})
    rep = report.build_report(tmp_path)
    assert rep["spans"]["simulate_batch"]["count"] == 2
    assert rep["scenarios"]["lat-0.3ms"]["evaluations"] == 8
    assert rep["scenarios"]["lat-0.8ms"]["evaluations"] == 4
    assert len(rep["workers"]) == 2
    text = report.render_report(rep)
    assert "simulate_batch" in text and "worker-1" in text
    assert "hit_rate=50.0%" in text
    want = ref_report.build_report(tmp_path)
    assert rep == want
    assert text == ref_report.render_report(want)
