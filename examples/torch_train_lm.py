"""End-to-end training example on the PyTorch port: train a ~100M-parameter dense LM
for a few hundred steps on the synthetic Markov stream, with checkpointing
and fault-tolerant resume. Counterpart of ``examples/train_lm.py``, with
its flags and defaults plus ``--device``.

The config (``CONFIG``) is a scaled-down qwen3-style decoder (~100M
params: 12 x 512, 8/4 heads, d_ff 2048, vocab 32768, qk-norm). Loss drops
well below the unigram entropy — the stream has real structure to learn.
A checkpoint is written every 100 steps and at the end; re-running on the
same ``--ckpt`` resumes from its latest step (``train.loop.run_training``
restores it and replays the stream from there), so ``--steps`` is the
total to reach, not the number to add. The reference's docstring names a
``--resume`` flag that its parser lacks; resuming needs none.

``--device`` defaults to ``cuda``; without a GPU the example raises unless
given ``--device cpu``.

  PYTHONPATH=src python examples/torch_train_lm.py [--steps 300]
  PYTHONPATH=src python examples/torch_train_lm.py --steps 400   # resumes at 300
  PYTHONPATH=src python examples/torch_train_lm.py --steps 20 --seq 64 --batch 2 \\
      --device cpu --ckpt /tmp/lm_cpu
"""
import argparse
import os
import sys
import tempfile
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).parent.parent / "src"))

from repro_torch.common import tree_leaves
from repro_torch.config import ModelConfig, RunConfig, ShapeConfig, TrainConfig
from repro_torch.data.synthetic import LMStream
from repro_torch.models import api
from repro_torch.train.loop import LoopConfig, run_training
from repro_torch.train.optim import make_optimizer
from repro_torch.train.steps import make_train_step

CONFIG = ModelConfig(
    name="lm-100m", family="dense", num_layers=12, d_model=512,
    num_heads=8, num_kv_heads=4, d_ff=2048, vocab_size=32768,
    use_qk_norm=True,
)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--ckpt", type=str,
                    default=os.path.join(tempfile.gettempdir(), "repro_train_lm"))
    ap.add_argument("--device", type=str, default="cuda",
                    help="the device the run trains on (default: the card)")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' was asked for, and this host has no GPU")

    cfg = CONFIG
    run = RunConfig(
        model=cfg,
        shape=ShapeConfig("train", args.seq, args.batch, "train"),
        train=TrainConfig(total_steps=args.steps, warmup_steps=20,
                          learning_rate=6e-4, microbatches=2),
    )
    step, _, _ = make_train_step(run, None)

    params = api.init(0, cfg, args.device)
    n_params = sum(p.numel() for p in tree_leaves(params))
    print(f"model: {n_params/1e6:.1f}M params")
    opt = make_optimizer(run.train)
    state = {"params": params, "opt": opt.init(params)}

    stream = LMStream(cfg.vocab_size, args.seq, args.batch, seed=0)

    def batch_at(i):
        return {k: torch.from_numpy(v).to(args.device)
                for k, v in stream.batch_at(i).items()}

    lcfg = LoopConfig(total_steps=args.steps, ckpt_every=100,
                      ckpt_dir=args.ckpt, log_every=20)
    res = run_training(step, state, batch_at, lcfg)
    first = res.metrics_history[0]["loss"]
    last = res.metrics_history[-1]["loss"]
    print(f"\nloss {first:.3f} -> {last:.3f} over {res.final_step} steps "
          f"({len(res.straggler_events)} straggler events)")
    assert last < first, "training failed to learn"
    return res


if __name__ == "__main__":
    main()
