"""Quickstart on the PyTorch port: a complete (tiny) NAHAS joint search, end
to end. Counterpart of ``examples/quickstart.py``.

Runs the paper's multi-trial joint search over a reduced MobileNetV2-style
NAS space × the full Table-1 accelerator space, with REAL proxy-task
training as the accuracy signal (the paper's 5-epoch ImageNet proxy, shrunk
to a synthetic vision task), then prints the chosen (architecture,
accelerator) pair and its simulator metrics. The PPO controller and every
candidate's training run on ``--device``; on the card each 1×1 convolution
of that training, forward and backward, is the ``ibn_pointwise`` kernel.
The settings are the module's constants, the reference's literals.

``--device`` defaults to ``cuda``; without a GPU the example raises unless
given ``--device cpu`` (about a minute there).

  PYTHONPATH=src python examples/torch_quickstart.py
  PYTHONPATH=src python examples/torch_quickstart.py --device cpu
"""
import argparse
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).parent.parent / "src"))

from repro_torch.core import has, nas, simulator
from repro_torch.core.proxy import TrainedAccuracy
from repro_torch.core.reward import RewardConfig
from repro_torch.core.search import SearchConfig
from repro_torch.core.session import SearchSession

SAMPLES = 24
BATCH = 8
TRAIN_STEPS = 60
TRAIN_BATCH = 32
LATENCY_TARGET_MS = 0.05


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="where the controller and the proxy training run "
                         "(default: the card)")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' was asked for, and this host has no GPU")

    space = nas.tiny_space()
    print(f"search space: {space.name}, {space.num_decisions} decisions, "
          f"cardinality {space.cardinality:.2e}")
    # real training per sample
    acc_fn = TrainedAccuracy(steps=TRAIN_STEPS, batch=TRAIN_BATCH, device=args.device)
    rcfg = RewardConfig(latency_target_ms=LATENCY_TARGET_MS,
                        area_target_mm2=simulator.BASELINE_AREA_MM2)
    # one session = one resolved evaluation context; .joint/.fixed_hw/... run
    # any number of searches against it (repro_torch.core.session)
    ses = SearchSession(space, acc_fn,
                        cfg=SearchConfig(samples=SAMPLES, batch=BATCH, seed=0,
                                         device=args.device))
    res = ses.joint(rcfg=rcfg)
    print(f"\nevaluated {len(res.history)} samples in {res.wall_s:.0f}s")
    best = res.best_record
    if best is None:
        print("no sample met the constraints — loosen the latency target")
        return res
    print(f"best: acc={best['accuracy']*100:.1f}%  "
          f"lat={best['latency_ms']:.4f}ms  energy={best['energy_mj']:.4f}mJ  "
          f"area={best['area_mm2']:.1f}mm^2")
    av = res.best_vec[: space.num_decisions]
    hv = res.best_vec[space.num_decisions:]
    print("chosen accelerator:", has.has_space().decode(hv))
    print("chosen blocks:")
    for b in space.decode(av).blocks:
        print("  ", b)
    return res


if __name__ == "__main__":
    main()
