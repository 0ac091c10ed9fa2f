"""Shared CLI surface for the runtime-backed scripts.

``scripts/torch_sweep.py`` (producer: runs searches, appends to the durable
store) and the reference's serve CLI (consumer: answers queries off the same
store/snapshot) share these flags. This module is the single source of truth
for them and for turning them into a ``SearchRuntime``:

* ``shared_parser()`` — an ``argparse`` *parent* parser (``add_help=False``)
  carrying ``--store``/``--snapshot``/``--preset``/``--quick`` and the
  budget flags; pass it via ``parents=[shared_parser()]`` so both CLIs
  accept identical spellings with identical semantics;
* ``build_runtime(args)`` — resolve the flags into a
  ``repro_torch.runtime.SearchRuntime`` (durable store, checkpointer, budget), or
  ``None`` when nothing durable was requested. Tolerates namespaces that
  lack the sweep-only flags (``--checkpoint-dir``/``--resume``/...), so the
  serve CLI can reuse it unchanged;
* ``start_trace(args)`` / ``finish_trace(args, tracer, extra=)`` — the
  ``--trace DIR`` lifecycle (``repro_torch.obs``): start the process tracer
  *before* the runtime is built (so per-namespace store accounting turns on
  with it), stop it and write ``metrics.json`` at exit.

Counterpart of ``repro/runtime/cli.py``: a copy.
"""
from __future__ import annotations

import argparse


def shared_parser() -> argparse.ArgumentParser:
    """Parent parser with the flags shared by the sweep and serve CLIs."""
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument(
        "--store",
        default=None,
        metavar="PATH",
        help="durable record store (append-only JSONL, reused across runs; "
        "sweep appends to it, serve reads it — read-only)",
    )
    ap.add_argument(
        "--snapshot",
        default=None,
        metavar="PATH",
        help="compacted frontier snapshot artifact (serve reads/merges it; "
        "sweep writes one after the run)",
    )
    ap.add_argument(
        "--preset",
        default=None,
        help="scenario preset name (see --list)",
    )
    ap.add_argument(
        "--quick",
        action="store_true",
        help="CI-sized mode: tiny space and 96 samples for sweeps, "
        "skip snapshot digest verification when serving",
    )
    ap.add_argument(
        "--budget-samples",
        type=int,
        default=None,
        help="evaluation budget: stop (checkpointing everything) after this "
        "many samples total; for serve, the admission budget per on-demand "
        "search",
    )
    ap.add_argument(
        "--deadline-s",
        type=float,
        default=None,
        help="wall-clock budget: stop (checkpointing everything) after this "
        "much time; for serve, the wait deadline per on-demand search",
    )
    ap.add_argument(
        "--trace",
        default=None,
        metavar="DIR",
        help="record telemetry into DIR: Chrome-trace spans "
        "(trace.jsonl, one .worker-<k> segment per process worker) plus "
        "metrics.json; merge and summarize with scripts/obs_report.py "
        "(off by default; tracing never changes results or store bytes)",
    )
    return ap


def start_trace(args):
    """Start the process tracer when ``--trace DIR`` was given (else None).
    Call before ``build_runtime``: stores built under an active tracer also
    record per-namespace hit rates."""
    trace_dir = getattr(args, "trace", None)
    if not trace_dir:
        return None
    from repro_torch.obs import trace as obs_trace

    return obs_trace.start(trace_dir)


def finish_trace(args, tracer, extra=None, file=None) -> None:
    """Stop the tracer started by ``start_trace`` and write the run's
    ``metrics.json`` (registry export + CLI-provided extras) next to the
    trace segments. No-op when tracing was off. ``file=`` redirects the
    summary line (the serve CLI keeps stdout for JSON answers)."""
    if tracer is None:
        return
    from repro_torch.obs import report as obs_report
    from repro_torch.obs import trace as obs_trace

    obs_trace.stop()
    obs_report.write_metrics(args.trace, extra=extra)
    print(
        f"trace: {args.trace} (merge + report with "
        f"scripts/obs_report.py {args.trace})",
        file=file,
    )


def build_runtime(args):
    """Resolve the shared + sweep-only flags into a ``SearchRuntime`` (or
    ``None``). Flags the calling CLI does not define are read as their
    defaults, so any namespace built on ``shared_parser()`` works."""
    store_path = getattr(args, "store", None)
    ck_dir = getattr(args, "checkpoint_dir", None)
    budget_samples = getattr(args, "budget_samples", None)
    deadline_s = getattr(args, "deadline_s", None)
    if store_path is None and ck_dir is None:
        if budget_samples is None and deadline_s is None:
            return None
    from repro_torch.runtime import Budget, Checkpointer, DurableRecordStore, SearchRuntime

    store = None
    if store_path is not None:
        if getattr(args, "no_share", False):
            raise SystemExit("--store and --no-share are contradictory")
        store = DurableRecordStore(store_path)
    if ck_dir is None and store_path is not None:
        ck_dir = store_path + ".ck"
    checkpoint = None
    if ck_dir is not None:
        checkpoint = Checkpointer(ck_dir)
        if not getattr(args, "resume", False):
            cleared = checkpoint.clear()
            if cleared:
                print(
                    f"cleared {cleared} stale checkpoint(s) in {ck_dir} "
                    f"(pass --resume to continue them)"
                )
    budget = None
    if budget_samples is not None or deadline_s is not None:
        budget = Budget(max_samples=budget_samples, deadline_s=deadline_s)
    return SearchRuntime(
        store=store,
        checkpoint=checkpoint,
        budget=budget,
        checkpoint_every=getattr(args, "checkpoint_every", 1),
    )
