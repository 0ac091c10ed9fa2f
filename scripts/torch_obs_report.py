"""Run-report CLI of the PyTorch port: merge a traced run's segments and
summarize it. Counterpart of ``scripts/obs_report.py``, with the same
flags, text and exit codes.

Point it at the directory a traced run wrote (``--trace DIR`` on
``scripts/torch_sweep.py`` / ``scripts/torch_runtime_serve.py``). It merges
the per-worker ``trace.jsonl.worker-<k>`` segments into one Chrome-trace
``trace.json`` (open it in https://ui.perfetto.dev or
``chrome://tracing``), validates the merged file against the trace event
schema, and prints the run report: top spans by cumulative wall time,
worker utilization, per-scenario evaluation counts, and the store's
per-namespace cache hit rates from ``metrics.json``. A directory that
holds no trace exits 2 with a message on stderr.

  PYTHONPATH=src python scripts/torch_sweep.py --quick --device cpu --trace /tmp/run
  PYTHONPATH=src python scripts/torch_obs_report.py /tmp/run
  PYTHONPATH=src python scripts/torch_obs_report.py /tmp/run --json
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent.parent / "src"))

from repro_torch.obs import report, trace


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="telemetry run report")
    ap.add_argument("trace_dir", help="directory holding trace.jsonl[.worker-*]")
    ap.add_argument(
        "--top", type=int, default=12, help="span rows to show (default 12)"
    )
    ap.add_argument(
        "--json", action="store_true", help="emit the report as JSON instead"
    )
    args = ap.parse_args(argv)

    if not trace.trace_paths(args.trace_dir):
        print(
            f"no {trace.TRACE_BASENAME}* files under {args.trace_dir}", file=sys.stderr
        )
        raise SystemExit(2)
    rep = report.build_report(args.trace_dir, top=args.top)
    if args.json:
        json.dump(rep, sys.stdout, indent=1, default=str)
        print()
    else:
        print(report.render_report(rep))
        print(
            f"\nmerged trace: {rep['trace']} "
            f"(load in https://ui.perfetto.dev or chrome://tracing)"
        )


if __name__ == "__main__":
    main()
