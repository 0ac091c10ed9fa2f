"""NAHAS applied to the pod, on the PyTorch port: jointly searching the mesh
factorization / microbatching / remat / FSDP / collective-style knobs for an
assigned architecture, the h-space transfer from DESIGN.md §2.
Counterpart of ``examples/codesign_mesh.py``, with its flags and defaults.

The pod cost model is host arithmetic; the PPO controller's updates run on
``--device``. On the CPU the output is the reference example's, character
for character. ``--device`` defaults to ``cuda``; without a GPU the example
raises unless given ``--device cpu``.

  PYTHONPATH=src python examples/torch_codesign_mesh.py --arch mistral-nemo-12b
  PYTHONPATH=src python examples/torch_codesign_mesh.py --arch qwen3-1.7b \\
      --samples 24 --device cpu
"""
import argparse
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).parent.parent / "src"))

from repro_torch import configs
from repro_torch.config import SHAPES
from repro_torch.core.meshsearch import DEFAULT_REF, PodCostModel, search_mesh


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", type=str, default="mistral-nemo-12b")
    ap.add_argument("--shape", type=str, default="train_4k")
    ap.add_argument("--samples", type=int, default=300)
    ap.add_argument("--device", type=str, default="cuda",
                    help="where the PPO controller's updates run (default: the card)")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' was asked for, and this host has no GPU")

    cfg = configs.get(args.arch)
    shape = SHAPES[args.shape]
    model = PodCostModel(cfg, shape)
    base = model.evaluate(dict(DEFAULT_REF))
    print(f"{args.arch} / {args.shape} on 256 chips")
    if base:
        print(f"default  (16,16) mesh: step {base['step_s']*1e3:.1f} ms  "
              f"mfu {base['mfu']:.3f}  dominant "
              f"{max(('compute_s','memory_s','collective_s'), key=base.get)}")
    res = search_mesh(cfg, shape, samples=args.samples, device=args.device)
    b = res.best
    print(f"searched {args.samples} configs -> step {b['step_s']*1e3:.1f} ms  "
          f"mfu {b['mfu']:.3f}")
    print("chosen:", res.best_cfg)
    valid = sum(1 for h in res.history if h.get("valid"))
    print(f"({valid}/{len(res.history)} sampled configs were valid — "
          f"the HAS space has invalid points, Sec. 3.3)")


if __name__ == "__main__":
    main()
