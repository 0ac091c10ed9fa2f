"""Scenario sweep on the PyTorch port: one evaluation substrate, many
deployment objectives. Counterpart of ``examples/scenario_sweep.py``.

Sweeps three divergent use cases — a tight-latency SKU, an energy-bounded
deployment and an area-bounded edge SKU — over the S1 MobileNetV2 space
through one shared evaluation memo, with the PPO controller on
``--device``, then shows the semi-decoupled payoff: a *new* scenario
defined after the searches ran is answered straight off the accumulated
Pareto frontier, with zero additional simulation. On the CPU its output is
the reference example's, character for character.

``--device`` defaults to ``cuda``; without a GPU the example raises unless
given ``--device cpu``.

  PYTHONPATH=src python examples/torch_scenario_sweep.py
  PYTHONPATH=src python examples/torch_scenario_sweep.py --device cpu
"""
import argparse
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).parent.parent / "src"))

from repro_torch.core import nas, proxy, sweep
from repro_torch.core.scenarios import Scenario
from repro_torch.core.search import SearchConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="where the PPO controller runs (default: the card)")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' was asked for, and this host has no GPU")

    runner = sweep.SweepRunner(
        ["lat-0.3ms", "energy-0.4mJ", "edge-sku-nano"],
        nas.s1_mobilenetv2(),
        proxy.SurrogateAccuracy(),
        sweep.SweepConfig(search=SearchConfig(samples=128, batch=16, seed=0,
                                              device=args.device)),
    )
    result = runner.run(verbose=True)
    print()
    print(result.table())

    # a scenario invented after the fact: served from the frontier, free
    late = Scenario(name="retrofit-0.6ms", latency_target_ms=0.6,
                    area_target_mm2=40.0)
    best = result.frontier.best(late)
    print(f"\nnew scenario {late.name} ({late.describe()}) answered from the "
          f"frontier without any new evaluation:")
    if best is None:
        print("  (frontier empty)")
    else:
        print(f"  acc={best['accuracy'] * 100:.2f}%  "
              f"lat={best['latency_ms']:.4f}ms  "
              f"area={best['area_mm2']:.1f}mm^2  "
              f"feasible={late.feasible(best)}")


if __name__ == "__main__":
    main()
