"""Serve "best config for scenario X" off a persisted record store (the
PyTorch port's serve CLI).

The CLI face of ``repro_torch.serve`` (co-design as a service). Sources, in
order of preference:

* ``--snapshot art.snap`` — memory-map a compacted frontier snapshot
  (``repro_torch.serve.snapshot``): no JSON log parsing at all, the warm path;
* ``--store s.jsonl`` — fold a ``repro_torch.runtime.DurableRecordStore`` log
  (as written by ``scripts/torch_sweep.py --store``) into the frontier, opened
  **read-only** so a live log with a concurrent writer is safe to serve.

Either way every valid raw record ends up in one Pareto frontier over
(accuracy, latency, energy, area) behind a ``FrontierServer``, and
per-scenario best-config queries are answered with **zero** search or
simulation — including for scenarios that were never searched: the
frontier contains an optimal record for any monotone objective (see
``repro_torch.core.pareto``).

  PYTHONPATH=src python scripts/torch_runtime_serve.py --store /tmp/s.jsonl --all
  PYTHONPATH=src python scripts/torch_runtime_serve.py --store /tmp/s.jsonl \\
      --compact-to /tmp/s.snap
  PYTHONPATH=src python scripts/torch_runtime_serve.py --snapshot /tmp/s.snap \\
      --scenario lat-0.3ms --scenario edge-sku-nano
  PYTHONPATH=src python scripts/torch_runtime_serve.py --store /tmp/s.jsonl \\
      --query lat=0.45,area=40,mode=soft
  PYTHONPATH=src python scripts/torch_runtime_serve.py --snapshot /tmp/s.snap --serve
  PYTHONPATH=src python scripts/torch_runtime_serve.py --store /tmp/s.jsonl \\
      --budget-samples 16 --space s1_mbv2 --accuracy trained \\
      --query lat=0.01,area=40

``--serve`` reads queries from stdin (one scenario name or ``key=value``
query per line) and answers each — a process holding the frontier in memory
answers in microseconds, which is the point: the expensive part was paid by
whatever populated the store. The exit summary on stderr reports the serve
stats; ``evaluations=0`` is load-bearing — CI greps it to prove the serve
tier never touched the simulator.

Snapshots are digest-verified at load by default (``--no-verify`` or
``--quick`` to trust them); a snapshot that fails verification is not served
— the CLI exits, or, when ``--store`` is also given, falls back to replaying
the durable log (the source of truth the snapshot was compacted from) with a
warning on stderr.

Flags shared with ``scripts/torch_sweep.py`` (one ``repro_torch.runtime.cli``
parent): ``--preset`` answers a whole scenario preset, ``--quick`` skips
snapshot digest verification, and ``--budget-samples``/``--deadline-s``
switch coverage misses from best-effort answers to budgeted on-demand
searches (``repro_torch.serve.AdmissionController``) whose results fold into
the live frontier. An admitted search samples ``--space`` (default ``tiny``)
with the ``--accuracy`` signal (default ``surrogate``; ``trained`` trains
every candidate on ``--device``, its 1×1 convolutions on the
``ibn_pointwise`` kernel, built before the first query), and its PPO /
REINFORCE controller runs on ``--device`` (default: the card). Nothing falls
back to the CPU: ask for it with ``--device cpu``.

Counterpart of ``scripts/runtime_serve.py``: the same flags, stdout and
stderr summary, plus ``--space``, ``--accuracy`` and ``--device`` with
``scripts/torch_sweep.py``'s spellings, and ``main(argv)``.
"""
from __future__ import annotations

import argparse
import json
import sys
from concurrent.futures import TimeoutError as FuturesTimeout
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent.parent / "src"))

from repro_torch.core import nas, proxy
from repro_torch.core import scenarios as scenarios_lib
from repro_torch.runtime import cli as runtime_cli
from repro_torch.serve import (
    FrontierServer,
    load_snapshot,
    load_store_frontier,
    snapshot_store,
)


def load_frontier(store_path: str):
    """Store log -> one frontier over every valid record (kept as the
    script's public helper; a read-only open — see
    ``repro_torch.serve.snapshot.load_store_frontier``)."""
    return load_store_frontier(store_path)


def parse_query(text: str) -> scenarios_lib.Scenario:
    """A scenario name, or an ad-hoc ``lat=0.5,energy=0.7,area=40,mode=soft``
    query built into an unregistered Scenario on the fly."""
    text = text.strip()
    if "=" not in text:
        return scenarios_lib.get(text)
    kw: dict = {"name": f"query({text})"}
    keys = {
        "lat": "latency_target_ms",
        "latency": "latency_target_ms",
        "energy": "energy_target_mj",
        "area": "area_target_mm2",
        "mode": "mode",
    }
    for part in text.split(","):
        k, _, v = part.partition("=")
        k = k.strip()
        if k not in keys:
            raise ValueError(f"unknown query key {k!r} (one of {sorted(keys)})")
        field = keys[k]
        kw[field] = v.strip() if field == "mode" else float(v)
    return scenarios_lib.Scenario(**kw)


def answer(
    server: FrontierServer,
    sc: scenarios_lib.Scenario,
    admission=None,
    deadline_s=None,
) -> dict:
    """Frontier answer; with an ``AdmissionController``, uncovered scenarios
    admit one budgeted on-demand search (waiting up to ``deadline_s``) and
    re-answer off the folded frontier."""
    if admission is None:
        return server.answer(sc)
    adm = admission.query(sc)
    if adm.future is not None:
        try:
            adm.future.result(timeout=deadline_s)
        except FuturesTimeout:
            pass  # deadline hit: fall through to the best-effort answer
        adm.answer = server.answer(sc)
    return adm.answer


def show(out: dict, as_json: bool) -> None:
    if as_json:
        print(json.dumps(out, default=str))
        return
    b = out["best"]
    if b is None:
        print(f"{out['scenario']:<22} {out['targets']:<34} (no valid record)")
        return
    energy = b.get("energy_mj")
    e_str = "   None" if energy is None else f"{energy:>7.4f}"
    print(
        f"{out['scenario']:<22} {out['targets']:<34} "
        f"acc={b['accuracy'] * 100:.2f}% lat={b['latency_ms']:.4f}ms "
        f"mJ={e_str.strip()} mm2={b['area_mm2']:.1f} "
        f"feasible={out['feasible']} paid_by={b.get('paid_by')} "
        f"vec={b.get('vec')}"
    )


def build_accuracy(args):
    """--accuracy -> the admission searches' accuracy signal. Trained
    accuracy on the card builds its kernel here, before any admission
    thread starts."""
    if args.accuracy == "surrogate":
        return proxy.SurrogateAccuracy()
    acc = proxy.TrainedAccuracy(steps=40, batch=64, device=args.device)
    acc.prepare()
    return acc


def build_parser() -> argparse.ArgumentParser:
    # --store/--snapshot/--preset/--quick/budget flags come from the shared
    # parent (repro_torch.runtime.cli) — same spellings as scripts/torch_sweep.py
    ap = argparse.ArgumentParser(
        description="best co-design configs off a persisted record store "
        "(PyTorch port)",
        parents=[runtime_cli.shared_parser()],
    )
    ap.add_argument(
        "--compact-to",
        metavar="PATH",
        help="compact --store into a snapshot artifact at PATH, then serve",
    )
    ap.add_argument(
        "--scenario",
        action="append",
        default=[],
        help="registered scenario name (repeatable)",
    )
    ap.add_argument(
        "--query",
        action="append",
        default=[],
        help="ad-hoc query, e.g. lat=0.5,area=40,mode=soft",
    )
    ap.add_argument(
        "--all", action="store_true", help="answer every registered scenario"
    )
    ap.add_argument(
        "--serve", action="store_true", help="read queries from stdin, one per line"
    )
    ap.add_argument("--json", action="store_true", help="one JSON object per answer")
    ap.add_argument(
        "--no-verify",
        action="store_true",
        help="trust --snapshot without digest verification (verification is "
        "on by default; --quick implies it too)",
    )
    ap.add_argument(
        "--space",
        default="tiny",
        choices=sorted(nas.SPACES),
        help="the architecture space admitted searches sample",
    )
    ap.add_argument(
        "--device",
        default="cuda",
        help="where admitted searches' PPO/REINFORCE controller and "
        "--accuracy trained run (default: the card)",
    )
    ap.add_argument(
        "--accuracy",
        default="surrogate",
        choices=("surrogate", "trained"),
        help="admitted searches' accuracy signal: the analytic surrogate, or "
        "real proxy training of every candidate on --device "
        "(TrainedAccuracy: 40 steps at batch 64, 32 px)",
    )
    return ap


def main(argv=None) -> None:
    ap = build_parser()
    args = ap.parse_args(argv)

    if args.store is None and args.snapshot is None:
        ap.error("pass --store and/or --snapshot")
    if args.compact_to and args.store is None:
        ap.error("--compact-to needs --store")

    # start tracing (--trace DIR) before any store/server construction so
    # fold/query spans and store accounting cover the whole session
    tracer = runtime_cli.start_trace(args)

    if args.compact_to:
        header, info = snapshot_store(args.store, args.compact_to)
        print(
            f"# compacted {args.store} ({info['records']} records) -> "
            f"{args.compact_to}: frontier {header['count']}, "
            f"{header['digest'][:19]}…",
            file=sys.stderr,
        )
        server = FrontierServer.from_snapshot(args.compact_to)
    elif args.snapshot is not None:
        # verification is the default: a serve tier must not answer off a
        # silently-corrupt artifact. --quick/--no-verify trust it (CI smoke /
        # local iteration); a failed verify falls back to replaying the
        # durable log when --store is also given — the log is the source of
        # truth the snapshot was compacted from.
        skip_verify = args.quick or args.no_verify
        snap = None
        try:
            snap = load_snapshot(args.snapshot, verify=not skip_verify)
        except Exception as e:  # noqa: BLE001 - any unreadable/corrupt artifact
            if args.store is None:
                raise SystemExit(
                    f"error: snapshot {args.snapshot} failed verification "
                    f"({e}); re-create it (--compact-to) or serve the store "
                    f"log directly (--store)"
                )
            print(
                f"# WARNING: snapshot {args.snapshot} failed verification "
                f"({e}); falling back to {args.store} log replay",
                file=sys.stderr,
            )
        if snap is not None:
            server = FrontierServer(snap.frontier())
            verified = "digest unverified" if skip_verify else "verified"
            print(
                f"# {args.snapshot}: frontier {snap.count} "
                f"(snapshot v{snap.header['version']}, {verified})",
                file=sys.stderr,
            )
        else:
            server = FrontierServer()
        if args.store is not None:
            frontier, info = load_store_frontier(args.store)
            server.merge_frontier(frontier)
            print(
                f"# {args.store}: {info['records']} records folded in, "
                f"frontier {len(server)}",
                file=sys.stderr,
            )
    else:
        frontier, info = load_store_frontier(args.store)
        server = FrontierServer(frontier)
        print(
            f"# {args.store}: {info['records']} records, "
            f"frontier {info['frontier']}, "
            f"{len(info['namespaces'])} namespace(s)",
            file=sys.stderr,
        )

    # budget flags turn coverage misses into budgeted on-demand searches
    # (repro_torch.serve.AdmissionController) instead of best-effort answers
    admission = None
    if args.budget_samples is not None or args.deadline_s is not None:
        from repro_torch.serve import AdmissionConfig, AdmissionController

        acfg = AdmissionConfig(
            budget_samples=args.budget_samples or 96, device=args.device
        )
        admission = AdmissionController(
            server, nas.SPACES[args.space](), build_accuracy(args), acfg
        )
        print(
            f"# admission: uncovered queries search on demand "
            f"(budget {acfg.budget_samples} samples, "
            f"deadline {args.deadline_s or 'none'})",
            file=sys.stderr,
        )

    queries = [parse_query(s) for s in args.scenario]
    queries += [parse_query(q) for q in args.query]
    if args.preset:
        queries += scenarios_lib.expand([args.preset])
    if args.all:
        queries += [scenarios_lib.get(n) for n in scenarios_lib.names()]
    for sc in queries:
        show(answer(server, sc, admission, args.deadline_s), args.json)

    if args.serve:
        print(
            "# serving; one scenario name or key=value query per line",
            file=sys.stderr,
        )
        for line in sys.stdin:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            try:
                show(
                    answer(server, parse_query(line), admission, args.deadline_s),
                    args.json,
                )
            except (KeyError, ValueError) as e:
                print(f"error: {e}", file=sys.stderr)
            sys.stdout.flush()
    elif not queries and not args.compact_to:
        ap.error("nothing to answer: pass --scenario/--query/--all/--serve")

    s = server.stats
    if admission is not None:
        admission.close()
        print(f"# admission: admitted={admission.admitted}", file=sys.stderr)
        suffix = f"{admission.admitted} on-demand search(es) admitted"
    else:
        suffix = "zero search, zero simulation"
    print(
        f"# served queries={s.queries} cache_hits={s.cache_hits} "
        f"indexed={s.index_answers} scanned={s.scan_answers} "
        f"evaluations={s.evaluations} ({suffix})",
        file=sys.stderr,
    )
    runtime_cli.finish_trace(
        args, tracer, extra={"serve_stats": s.as_dict()}, file=sys.stderr
    )


if __name__ == "__main__":
    main()
