"""Training launcher: compose (arch × shape) into a training run on the
card unless ``--device cpu``. ``--smoke`` takes the reduced same-family
config (CPU-sized); without it the full config trains. ``--mesh DxM``
trains sharded over a (data=D, model=M) mesh of D·M ranks started by
``torchrun``, with the state placed by the step's spec trees. Counterpart
of ``repro/launch/train.py``.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b --smoke \\
      --steps 50 --device cpu
  PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 4 \\
      -m repro_torch.launch.train --arch qwen3-1.7b --smoke --steps 3 --mesh 2x2 \\
      --device cpu
"""
from __future__ import annotations

import argparse
import os
import tempfile

import torch
import torch.distributed as dist

from repro_torch import configs
from repro_torch.config import RunConfig, ShapeConfig, TrainConfig
from repro_torch.data.synthetic import LMStream
from repro_torch.models import api
from repro_torch.parallel import ctx as pctx
from repro_torch.parallel.sharding import distribute_tree
from repro_torch.train.loop import LoopConfig, run_training
from repro_torch.train.optim import make_optimizer
from repro_torch.train.steps import make_train_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", type=str, required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--ckpt", type=str,
                    default=os.path.join(tempfile.gettempdir(), "repro_launch_train"))
    ap.add_argument("--mesh", type=str, default=None,
                    help="e.g. 2x4 -> (data=2, model=4); default single device")
    ap.add_argument("--device", type=str, default="cuda",
                    help="the device the run trains on (default: the card)")
    args = ap.parse_args(argv)

    cfg = configs.smoke(args.arch) if args.smoke else configs.get(args.arch)
    if cfg.family in ("audio", "vlm"):
        raise SystemExit("train launcher example covers token-LM families; "
                         "audio/vlm train via the dry-run cells")
    run = RunConfig(
        model=cfg,
        shape=ShapeConfig("cli", args.seq, args.batch, "train"),
        train=TrainConfig(total_steps=args.steps, warmup_steps=5,
                          learning_rate=1e-3),
    )
    pc, device, lead = None, args.device, True
    if args.mesh:
        pc, device = _world(args.mesh, args.device)
        lead = dist.get_rank() == 0
    try:
        step, sspecs, bspecs = make_train_step(run, pc)
        params = api.init(run.train.seed, cfg, device=device)
        opt = make_optimizer(run.train)
        state = {"params": params, "opt": opt.init(params)}
        if pc is not None:
            state = distribute_tree(state, sspecs, pc.mesh)
        stream = LMStream(cfg.vocab_size, args.seq, args.batch, seed=0)

        def batch_at(i):
            batch = {k: torch.from_numpy(v).to(device) for k, v in stream.batch_at(i).items()}
            return batch if pc is None else distribute_tree(batch, bspecs, pc.mesh)

        res = run_training(
            step, state, batch_at,
            LoopConfig(total_steps=args.steps, ckpt_every=max(args.steps // 2, 10),
                       ckpt_dir=f"{args.ckpt}_{configs.ALIASES.get(args.arch, args.arch)}",
                       log_every=10),
            log_fn=print if lead else (lambda line: None),
        )
        if lead:
            print(f"done: {res.final_step} steps, last loss "
                  f"{res.metrics_history[-1]['loss']:.3f}")
    finally:
        if pc is not None:
            dist.destroy_process_group()


def _world(mesh_arg: str, device: str):
    """(ParallelCtx, rank's device) of a ``DxM`` mesh over the ranks
    ``torchrun`` started, whose number must be D·M."""
    from repro_torch.launch import mesh as M

    d, m = (int(x) for x in mesh_arg.split("x"))
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world != d * m:
        raise SystemExit(f"--mesh {mesh_arg} needs {d * m} ranks (torchrun "
                         f"--nproc-per-node {d * m}); WORLD_SIZE is {world}")
    rank = int(os.environ["RANK"])
    backend = M.init_world(rank, world, device, init_method="env://")
    if rank == 0:
        print(f"[mesh] {d}x{m} (data, model) over {world} ranks, backend {backend}")
    pc = pctx.from_mesh(M.make_mesh((d, m), ("data", "model"), device=device))
    return pc, M.rank_device(device, rank, world)


if __name__ == "__main__":
    main()
