#!/usr/bin/env python3
"""The train phase's three training steps on the card with a tree's own
``chip_smoke.py`` and ``src/``: qwen3-1.7B (28 layers, remat full),
mamba2-370m (48 layers) and qwen2-moe-a2.7b cut to 2 layers, 8 x 1024
tokens a step, bf16 compute (``chip_smoke._train_model``: 3 warm-up, 10
timed and 3 profiled steps, the launches of each kernel per step checked).

    python scripts/train_step_trees.py [--root DIR]

``--root`` is a checkout whose ``chip_smoke.py`` and ``src`` are imported
(default: this one), so that two trees' steps are timed on one card in one
call: run it for each, in turns (A, B, B, A). Prints the card's name and
power limit, chip_smoke's train lines, then one JSON line ``{"root",
"steps": {model: {"ms", "device_ms", "by_kernel", "ranges",
"launches_per_step", "peak_gb"}}}``. Needs a CUDA card; exits 1 without
one.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(ROOT))
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()
    sys.path[:0] = [str(root / "src"), str(root)]
    import torch

    if not torch.cuda.is_available():
        print("train_step_trees: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card)
    qwen3 = cs.configs.get(cs.SERVE_ARCH).scaled(attn_impl="flash_pallas")
    mamba = cs.configs.get(cs.SSM_ARCH)
    # K3's backward launches in this tree (trees from before the constant ran five)
    k3 = getattr(cs.ssd_scan, "BWD_LAUNCHES", 5)
    moe = cs.configs.get(cs.MOE_ARCH).scaled(num_layers=cs.TRAIN_MOE_LAYERS,
                                             attn_impl="flash_pallas")
    runs = {
        "qwen3": (qwen3, "full", {"flash_attention": 4 * qwen3.num_layers,
                                  "flash_attention_bwd": 2 * qwen3.num_layers}),
        "mamba2": (mamba, "none", {"ssd_scan": (1 + k3) * mamba.num_layers,
                                   "ssd_scan_bwd": k3 * mamba.num_layers}),
        "moe": (moe, "none", {"gmm": 9 * cs.TRAIN_MOE_LAYERS,
                              "flash_attention": 3 * cs.TRAIN_MOE_LAYERS,
                              "flash_attention_bwd": 2 * cs.TRAIN_MOE_LAYERS}),
    }
    out = {}
    for name, (cfg, remat, expect) in runs.items():
        r = cs._train_model(card, f"{name} ({root.name})", cfg, remat, expect,
                            n_steps=cs.TRAIN_WARMUP + cs.TRAIN_TIMED + cs.TRAIN_PROFILED)
        out[name] = {k: r[k] for k in ("ms", "device_ms", "by_kernel", "ranges",
                                       "launches_per_step", "peak_gb")}
        torch.cuda.empty_cache()
    print(json.dumps({"root": str(root), "steps": out}, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
