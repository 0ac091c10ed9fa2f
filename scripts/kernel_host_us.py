#!/usr/bin/env python3
"""Host µs per call of the port's K2, K3 and K4 as the model calls them
(``kernels.ops``, no autograd), on the card, at the serve phases' shapes:
K2 at qwen3-1.7B's prefill (B 8, S 1024, H 16, KV 8, hd 128), K3 at
mamba2-370m's (B 8, S 1024, H 32, P 64, N 128, chunk 256) and K4 at
qwen2-moe-a2.7b's decode gate/up product (60, 32, 2048, 1408), bf16.

    python scripts/kernel_host_us.py [--src DIR] [--calls N]

``--src`` is the ``src`` directory whose ``repro_torch`` is imported
(default: this checkout's), so that two trees' wrappers are timed on one
card in one call: run it for each, in turns (A, B, B, A). The time is
``chip_smoke.host_us``'s: the host's time to issue ``--calls`` calls back
to back, after 5 unmeasured ones. Prints the card's name and power limit,
then one JSON line: ``{"src", "us": {kernel: µs per call}, "launches"}``.
Needs a CUDA card; exits 1 without one.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def host_us(fn, calls: int) -> float:
    import torch

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e6 / calls


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--calls", type=int, default=200)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch

    if not torch.cuda.is_available():
        print("kernel_host_us: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import flash_attention, gmm, ops, ssd_scan

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0])
    dev, bf = "cuda", torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, dtype=bf):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    q, k = randn(8, 1024, 16, 128), randn(8, 1024, 8, 128)
    x, bc = randn(8, 1024, 32, 64), randn(8, 1024, 1, 128)
    dt = torch.rand((8, 1024, 32), generator=gen, device=dev) * 0.1
    a = -torch.rand((32,), generator=gen, device=dev)
    xe, we = randn(60, 32, 2048), randn(60, 2048, 1408)
    calls = {"flash_attention": lambda: ops.flash_attention(q, k, k),
             "ssd_scan": lambda: ops.ssd_scan(x, dt, a, bc, bc, chunk=256),
             "gmm": lambda: ops.gmm(xe, we)}
    mods = {"flash_attention": flash_attention, "ssd_scan": ssd_scan, "gmm": gmm}
    us, launches = {}, {}
    with torch.no_grad():
        for name, fn in calls.items():
            mods[name].LAUNCHES = 0
            us[name] = host_us(fn, args.calls)
            launches[name] = mods[name].LAUNCHES
    print(json.dumps({"src": args.src, "us": us, "launches": launches}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
