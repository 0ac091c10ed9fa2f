"""Training launcher: compose (arch × shape) into a training run on one
device, the card unless ``--device cpu``. ``--smoke`` takes the reduced
same-family config (CPU-sized); without it the full config trains. The
sharded run over a mesh (``--mesh``) comes with the port's parallel slice.
Counterpart of ``repro/launch/train.py``.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b --smoke \\
      --steps 50 --device cpu
"""
from __future__ import annotations

import argparse
import os
import tempfile

import torch

from repro_torch import configs
from repro_torch.config import RunConfig, ShapeConfig, TrainConfig
from repro_torch.data.synthetic import LMStream
from repro_torch.models import api
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
    if args.mesh:
        raise NotImplementedError("training over a mesh (--mesh) comes with the port's "
                                  "parallel slice")
    run = RunConfig(
        model=cfg,
        shape=ShapeConfig("cli", args.seq, args.batch, "train"),
        train=TrainConfig(total_steps=args.steps, warmup_steps=5,
                          learning_rate=1e-3),
    )
    step, _, _ = make_train_step(run)
    params = api.init(run.train.seed, cfg, device=args.device)
    opt = make_optimizer(run.train)
    state = {"params": params, "opt": opt.init(params)}
    stream = LMStream(cfg.vocab_size, args.seq, args.batch, seed=0)

    def batch_at(i):
        return {k: torch.from_numpy(v).to(args.device) for k, v in stream.batch_at(i).items()}

    res = run_training(
        step, state, batch_at,
        LoopConfig(total_steps=args.steps, ckpt_every=max(args.steps // 2, 10),
                   ckpt_dir=f"{args.ckpt}_{configs.ALIASES.get(args.arch, args.arch)}",
                   log_every=10),
    )
    print(f"done: {res.final_step} steps, last loss "
          f"{res.metrics_history[-1]['loss']:.3f}")


if __name__ == "__main__":
    main()
