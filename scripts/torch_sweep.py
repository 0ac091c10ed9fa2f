"""Scenario-sweep CLI of the PyTorch port: N deployment use cases, one shared
evaluation memo.

Runs the multi-use-case Pareto co-design sweep (``repro_torch.core.sweep``)
over named scenario presets (``repro_torch.core.scenarios``) and prints the
per-scenario best-config table plus the shared-store cache counters,
including the cross-scenario hit rate. The PPO / REINFORCE controller runs
on ``--device`` (the card by default); ``--accuracy trained`` trains every
candidate on that device (``TrainedAccuracy``, its 1×1 convolutions on the
``ibn_pointwise`` kernel), which this script builds before any worker
process is spawned. Nothing falls back to the CPU: ask for it with
``--device cpu``.

Durable mode (``repro_torch.runtime``): ``--store PATH`` persists every evaluation
to an append-only JSONL log and checkpoints each search per batch (under
``--checkpoint-dir``, default ``PATH.ck``) — kill the process at any point
and re-run with ``--resume`` to continue exactly where it stopped; a second
full run against the same store re-simulates nothing. ``--workers N`` runs
the scenarios concurrently (``repro_torch.runtime.SearchExecutor``) — add
``--processes`` to shard them across N spawned worker processes, each
appending to its own single-writer store segment (log shipping; merged
back on return, retired by ``--compact``), and ``--devices-per-worker D``
to give each worker D cards of its own. ``--budget-samples`` /
``--deadline-s`` bound the run, checkpointing everything in flight when
the budget expires (exit code 3: resumable). ``--snapshot PATH`` compacts the
store's frontier into a serve-tier snapshot artifact after a run that was not
interrupted (``repro_torch.serve.snapshot_store``; it needs ``--store``),
which ``scripts/torch_runtime_serve.py --snapshot`` serves. Shared flags live
in ``repro_torch.runtime.cli``.

Process mode self-heals: a crashed or hung worker (``--job-deadline-s``) is
killed and respawned, its job retried from checkpoint up to
``--max-job-retries`` times, so the sweep completes in one invocation; the
greppable ``recovery:`` stderr line reports the counters. Set
``REPRO_FAULTS`` (``repro_torch.runtime.faults``) to inject deterministic
chaos.

Backends (``--backend``, see ``repro_torch.hw``): ``analytic`` (exact simulator,
default), ``learned`` (an MLP cost model trained on the fly, energy head
included), ``cascade`` (vectorized lower-bound prefilter in front of the
simulator — skips full simulation for candidates the cheap bound already
rules out, and prints the per-stage prune counters).

  PYTHONPATH=src python scripts/torch_sweep.py --preset paper-use-cases --quick
  PYTHONPATH=src python scripts/torch_sweep.py --quick --backend cascade
  PYTHONPATH=src python scripts/torch_sweep.py --quick --backend learned
  PYTHONPATH=src python scripts/torch_sweep.py --preset fig8-latency --space s1_mbv2
  PYTHONPATH=src python scripts/torch_sweep.py --scenarios lat-0.3ms,edge-sku-nano
  PYTHONPATH=src python scripts/torch_sweep.py --quick --store /tmp/s.jsonl
  PYTHONPATH=src python scripts/torch_sweep.py --quick --store /tmp/s.jsonl --resume
  PYTHONPATH=src python scripts/torch_sweep.py --quick --store /tmp/s.jsonl \\
      --snapshot /tmp/s.snap
  PYTHONPATH=src python scripts/torch_sweep.py --quick --store /tmp/s.jsonl \\
      --workers 4 --processes
  PYTHONPATH=src python scripts/torch_sweep.py --grid 24 --transfer --quick \\
      --backend cascade
  PYTHONPATH=src python scripts/torch_sweep.py --grid --transfer \\
      --store /tmp/grid.jsonl --workers 4 --processes
  PYTHONPATH=src python scripts/torch_sweep.py --quick --store /tmp/s.jsonl \\
      --accuracy trained --workers 2 --processes
  PYTHONPATH=src python scripts/torch_sweep.py --list
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent.parent / "src"))

from repro_torch.core import nas, proxy, scenarios, sweep
from repro_torch.core.search import SearchConfig, SearchInterrupted
from repro_torch.runtime import cli as runtime_cli

EXIT_INTERRUPTED = 3  # budget/deadline expired; re-run with --resume


def build_parser() -> argparse.ArgumentParser:
    # --store/--snapshot/--preset/--quick and the budget flags come from the
    # shared parent (repro_torch.runtime.cli)
    ap = argparse.ArgumentParser(
        description="multi-use-case co-design sweep (PyTorch port)",
        parents=[runtime_cli.shared_parser()],
    )
    ap.add_argument(
        "--scenarios", default=None, help="comma-separated scenario/preset names"
    )
    ap.add_argument("--driver", default="joint", choices=sorted(sweep.DRIVERS))
    ap.add_argument(
        "--backend",
        default="analytic",
        choices=("analytic", "learned", "cascade"),
        help="hardware cost backend (repro_torch.hw): exact simulator, MLP cost "
        "model trained on the fly (with an energy head), or the "
        "lower-bound-then-simulate cascade",
    )
    ap.add_argument("--space", default="s1_mbv2", choices=sorted(nas.SPACES))
    ap.add_argument(
        "--samples", type=int, default=256, help="search samples per scenario"
    )
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--controller", default="ppo")
    ap.add_argument(
        "--device",
        default="cuda",
        help="where the PPO/REINFORCE controller, the learned backend's cost "
        "model and --accuracy trained run (default: the card)",
    )
    ap.add_argument(
        "--accuracy",
        default="surrogate",
        choices=("surrogate", "trained"),
        help="accuracy signal: the analytic surrogate, or real proxy training "
        "of every candidate on --device (TrainedAccuracy: 40 steps at batch "
        "64, 32 px)",
    )
    ap.add_argument(
        "--no-share",
        action="store_true",
        help="ablation: per-scenario private caches instead of the shared store",
    )
    ap.add_argument(
        "--checkpoint-dir",
        default=None,
        metavar="DIR",
        help="search checkpoints (default: <store>.ck when --store is given)",
    )
    ap.add_argument(
        "--resume",
        action="store_true",
        help="resume from existing checkpoints (default: start fresh, "
        "clearing them — store evaluations are reused either way)",
    )
    ap.add_argument(
        "--workers",
        type=int,
        default=0,
        metavar="N",
        help="run scenarios concurrently on N threads (0 = serial), or on "
        "N sharded worker processes with --processes",
    )
    ap.add_argument(
        "--processes",
        action="store_true",
        help="shard scenarios across --workers spawned processes, each "
        "appending to its own store segment (log shipping; needs --store, "
        "or runs private per-worker caches without one)",
    )
    ap.add_argument(
        "--transfer",
        action="store_true",
        help="scenario-transfer scheduling (repro_torch.core.sweep.plan_transfer): "
        "feature-space medoids run cold at the full budget, every other "
        "scenario warm-starts from its nearest medoid's checkpoint at a "
        "quarter budget (joint/fixed_hw drivers)",
    )
    ap.add_argument(
        "--transfer-samples",
        type=int,
        default=None,
        metavar="N",
        help="samples for warm (transferred) searches (default: samples/4)",
    )
    ap.add_argument(
        "--transfer-medoids",
        type=int,
        default=None,
        metavar="K",
        help="cold medoid count (default: ceil(sqrt(scenarios)))",
    )
    ap.add_argument(
        "--grid",
        type=int,
        default=None,
        nargs="?",
        const=0,
        metavar="N",
        help="sweep the registered scenario grid (repro_torch.core.scenarios.grid: "
        "LLM model × train/serve × seq len × SKU × traffic tier, targets "
        "derived through the pod roofline); N caps the expansion, bare "
        "--grid takes the full product",
    )
    ap.add_argument(
        "--devices-per-worker",
        type=int,
        default=None,
        metavar="D",
        help="give each worker process D cards of its own "
        "(CUDA_VISIBLE_DEVICES: worker k sees cards k*D .. k*D+D-1, wrapped "
        "over the host's cards); default: every worker sees every card",
    )
    ap.add_argument(
        "--max-job-retries",
        type=int,
        default=3,
        metavar="N",
        help="failed/crashed scenario jobs are retried (resuming from their "
        "checkpoints) up to N times before quarantine (0 = fail fast)",
    )
    ap.add_argument(
        "--job-deadline-s",
        type=float,
        default=None,
        metavar="S",
        help="kill a scenario job running longer than S seconds (measured "
        "from its start ack) and retry it — hung-worker protection",
    )
    ap.add_argument(
        "--checkpoint-every",
        type=int,
        default=1,
        metavar="B",
        help="batches between checkpoint saves (1 = maximal durability; "
        "each save rewrites the search's full state, so raise this for "
        "long searches)",
    )
    ap.add_argument(
        "--compact",
        action="store_true",
        help="compact the durable store log before exiting",
    )
    ap.add_argument(
        "--json", default=None, metavar="PATH", help="also write the result as JSON"
    )
    ap.add_argument(
        "--list", action="store_true", help="list scenarios and presets, then exit"
    )
    return ap


def build_backend(args, runner):
    """--backend -> a repro_torch.hw CostBackend shared by every scenario
    engine (None = the default analytic backend)."""
    if args.backend == "analytic":
        return None
    if args.backend == "cascade":
        from repro_torch.hw import CascadeBackend

        return CascadeBackend(scenarios=tuple(runner.scenarios))
    # learned: label a dataset with the simulator and train the MLP with the
    # energy head, so energy-target scenarios run on the learned path too
    from repro_torch.core import costmodel
    from repro_torch.hw import LearnedBackend

    n, steps = (1500, 3000) if args.quick else (6000, 10000)
    print(f"training cost model ({n} samples, {steps} steps)...", flush=True)
    feats, lat, area, energy = costmodel.generate_dataset(
        runner.nas_space,
        runner.has_space,
        n,
        seed=args.seed,
        include_energy=True,
    )
    model, metrics = costmodel.train(
        feats,
        lat,
        area,
        costmodel.CostModelConfig(steps=steps),
        energy_mj=energy,
        device=args.device,
    )
    print(
        f"cost model: lat mape {metrics['val_latency_mape']:.1%}, "
        f"area mape {metrics['val_area_mape']:.1%}, "
        f"energy mape {metrics['val_energy_mape']:.1%}"
    )
    return LearnedBackend(model, runner.nas_space, runner.has_space)


def build_accuracy(args):
    """--accuracy -> the sweep's accuracy signal. Trained accuracy on the
    card builds its kernel here, once, before any worker is spawned."""
    if args.accuracy == "surrogate":
        return proxy.SurrogateAccuracy()
    acc = proxy.TrainedAccuracy(steps=40, batch=64, device=args.device)
    acc.prepare()
    return acc


def main(argv=None) -> None:
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.snapshot and not args.store:
        ap.error("--snapshot needs --store (the snapshot compacts its log)")
    if args.processes and not args.workers:
        ap.error("--processes needs --workers N")

    if args.list:
        print("scenarios:")
        for name in scenarios.names():
            print(f"  {name:<18} {scenarios.get(name).describe()}")
        print("presets:")
        for name, members in sorted(scenarios.PRESETS.items()):
            print(f"  {name:<18} {', '.join(members)}")
        return

    selected: list = []
    if args.grid is not None:
        selected.extend(
            scenarios.grid(limit=args.grid if args.grid > 0 else None)
        )
    if args.preset:
        selected.append(args.preset)
    if args.scenarios:
        selected.extend(s.strip() for s in args.scenarios.split(",") if s.strip())
    if not selected:
        selected.append("paper-use-cases")

    space_name = "tiny" if args.quick else args.space
    samples = min(args.samples, 96) if args.quick else args.samples
    space = nas.SPACES[space_name]()
    # tracing starts before the runtime so the store (and every engine) is
    # built under the active tracer; process workers inherit enablement via
    # the executor's env handoff
    tracer = runtime_cli.start_trace(args)
    runtime = runtime_cli.build_runtime(args)
    cfg = sweep.SweepConfig(
        driver=args.driver,
        search=SearchConfig(
            samples=samples,
            batch=args.batch,
            seed=args.seed,
            controller=args.controller,
            device=args.device,
        ),
        share_cache=not args.no_share,
        workers=args.workers,
        processes=args.processes,
        devices_per_worker=args.devices_per_worker,
        transfer=args.transfer,
        transfer_samples=args.transfer_samples,
        transfer_medoids=args.transfer_medoids,
        max_job_retries=args.max_job_retries,
        job_deadline_s=args.job_deadline_s,
    )
    runner = sweep.SweepRunner(selected, space, build_accuracy(args), cfg)
    cfg.backend = build_backend(args, runner)
    extras = f", store={args.store}" if args.store else ""
    if args.workers:
        extras += f", workers={args.workers}"
        if args.processes:
            extras += " (processes)"
    print(
        f"sweep: {len(runner.scenarios)} scenarios × {samples} samples, "
        f"driver={args.driver}, backend={args.backend}, space={space_name}, "
        f"accuracy={args.accuracy}, device={args.device}, "
        f"shared cache={'on' if cfg.share_cache else 'off'}{extras}"
    )

    interrupted = False
    try:
        # serial or concurrent: SweepRunner dispatches on cfg.workers
        result = runner.run(verbose=True, runtime=runtime)
    except SearchInterrupted as e:
        print(f"\n{e}")
        interrupted = True
        result = None

    if result is not None:
        print()
        print(result.table())
        print(f"wall: {result.wall_s:.1f}s")
        if result.recovery is not None:
            rec = result.recovery
            ckpt_corrupt = (result.store_stats or {}).get("ckpt_corrupt", 0)
            # stderr, one greppable line: CI's chaos smoke asserts on it
            print(
                f"recovery: retries={rec.get('retries', 0)} "
                f"respawns={rec.get('respawns', 0)} "
                f"deadline_kills={rec.get('deadline_kills', 0)} "
                f"heartbeat_kills={rec.get('heartbeat_kills', 0)} "
                f"crashes={rec.get('crashes', 0)} "
                f"quarantined={rec.get('quarantined', 0)} "
                f"ckpt_corrupt={ckpt_corrupt}",
                file=sys.stderr,
            )
        casc = getattr(cfg.backend, "stats", None)
        if casc is not None and args.backend == "cascade":
            print(
                f"cascade: {casc.refined}/{casc.requested} candidates fully "
                f"simulated — pruned {casc.pruned} "
                f"(static {casc.static_invalid}, envelope "
                f"{casc.envelope_pruned}, dominated {casc.dominance_pruned})"
            )
        if args.json:
            with open(args.json, "w") as f:
                json.dump(result.as_dict(), f, indent=1, default=str)
            print(f"wrote {args.json}")

    if runtime is not None and runtime.store is not None:
        from repro_torch.runtime import DurableRecordStore

        store = runtime.store
        if isinstance(store, DurableRecordStore):
            if args.compact:
                dropped = store.compact()
                print(f"compacted {args.store}: dropped {dropped} stale lines")
            store.close()
            print(
                f"store: {len(store)} records in {args.store} "
                f"(loaded {store.loaded}, appended {store.appended})"
            )
            if args.snapshot and not interrupted:
                from repro_torch.serve import snapshot_store

                header, _info = snapshot_store(args.store, args.snapshot)
                print(f"snapshot: frontier {header['count']} -> {args.snapshot}")

    if tracer is not None:
        extra: dict = {}
        if result is not None:
            extra["scenarios"] = {
                o.scenario.name: o.result.engine_stats for o in result.outcomes
            }
            if result.store_stats is not None:
                extra["store_stats"] = result.store_stats
        if runtime is not None and runtime.store is not None:
            ns = runtime.store.namespace_stats()
            if ns:
                extra["namespaces"] = ns
        runtime_cli.finish_trace(args, tracer, extra=extra)

    if interrupted:
        if runtime is not None and runtime.checkpoint is not None:
            print(
                "budget exhausted — all in-flight searches checkpointed; "
                "re-run with --resume to continue"
            )
        else:
            print(
                "budget exhausted — nothing was checkpointed (pass --store "
                "or --checkpoint-dir to make interrupted runs resumable)"
            )
        raise SystemExit(EXIT_INTERRUPTED)


if __name__ == "__main__":
    main()
