#!/usr/bin/env python3
"""K2's and K3's backward kernels on the card: each held against its plain
backward (``ref.flash_attention_bwd``, ``ref.ssd_chunked_bwd``) at a set of
shapes in fp32 and bf16, twice bitwise the same, then timed at the training
shapes (qwen3-1.7B's attention, B 8, H 16, KV 8, S 1024, hd 128, causal;
mamba2-370m's scan, B 8, S 1024, H 32, P 64, N 128, chunk 256; bf16) with
each launch's device time from torch's profiler.

    PYTHONPATH=src python scripts/backward_kernels.py

Prints the card's name and power limit, one line per check (each
gradient's max error over max(1, its max |plain value|)), the times, and a
last JSON line ``{"failed": [...], "ms": {...}, "kernels_us": {...}}``;
exits 1 when a check fails its limit (fp32 1e-4, bf16 2e-2). The fp32
scan at chunk 4096 is printed but held at 1e-3, chip_smoke.SSD_TOL's fp32
limit: there the chunk's cumsum reaches thousands and the kernel's and
the plain backward's sums in another order part by about 1e-4. Needs a
CUDA card; exits 1 without one.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
from repro_torch.kernels import flash_attention as kfa  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import ssd_scan as kssd  # noqa: E402

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# (b, h, kv, sq, skv, hd, causal)
ATTN = [(1, 2, 1, 64, 64, 16, True), (2, 4, 2, 100, 100, 32, True),
        (1, 4, 4, 77, 130, 64, False), (1, 2, 1, 200, 120, 80, True),
        (1, 4, 2, 120, 200, 112, True), (2, 4, 2, 256, 256, 128, True),
        (1, 2, 1, 130, 130, 256, True), (1, 8, 8, 33, 65, 128, False)]
# (b, s, h, p, g, n, chunk, with the final state's cotangent)
SSD = [(1, 64, 2, 16, 1, 32, 64, False), (2, 100, 4, 16, 2, 16, 32, True),
       (1, 37, 2, 8, 1, 8, 16, True), (2, 300, 4, 64, 1, 128, 256, False),
       (2, 512, 112, 64, 1, 64, 256, False), (1, 1000, 4, 64, 4, 128, 256, True),
       (1, 130, 32, 64, 1, 128, 256, True), (1, 4096, 2, 64, 1, 128, 4096, False)]


def rel(got, want) -> float:
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max().clamp_min(1.0)).item()


def attention(b, h, kv, sq, skv, hd, causal, dtype, gen):
    """q, k, v, the forward kernel's output and log-sum-exp, do: the
    model's (B, S, heads, hd) layout as (B, heads, S, hd) views."""
    def draw(heads, rows):
        return torch.randn((b, rows, heads, hd), generator=gen, device="cuda").to(
            dtype).transpose(1, 2)

    q, k, v, do = draw(h, sq), draw(kv, skv), draw(kv, skv), draw(h, sq)
    o, lse = kfa.launch(q, k, v, causal=causal, with_lse=True)
    return q, k, v, o, lse, do


def scan(b, s, h, p, g, n, dtype, gen, with_state):
    """x, dt, A, B, C, dy and the state's cotangent (or None)."""
    x = torch.randn((b, s, h, p), generator=gen, device="cuda").to(dtype)
    dt = torch.nn.functional.softplus(torch.randn((b, s, h), generator=gen, device="cuda") - 2)
    A = -torch.exp(2 * torch.rand((h,), generator=gen, device="cuda"))
    B, C = (torch.randn((b, s, g, n), generator=gen, device="cuda").to(dtype) for _ in "BC")
    dy = torch.randn((b, s, h, p), generator=gen, device="cuda").to(dtype)
    dst = torch.randn((b, h, p, n), generator=gen, device="cuda") if with_state else None
    return x, dt, A, B, C, dy, dst


def ms(fn, iters: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    if not torch.cuda.is_available():
        print("backward_kernels: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    gen = torch.Generator("cuda").manual_seed(0)
    failed = []
    for dtype in (torch.float32, torch.bfloat16):
        for shape in ATTN:
            args = attention(*shape, dtype, gen)
            got = kfa.launch_bwd(*args, causal=shape[6])
            again = kfa.launch_bwd(*args, causal=shape[6])
            q, k, v, o, lse, do = args
            want = ref.flash_attention_bwd(q, k, v, o, do, causal=shape[6])
            errs = [rel(a, w) for a, w in zip(got, want)]
            same = all(torch.equal(a, c) for a, c in zip(got, again))
            ok = max(errs) <= TOL[dtype] and same
            print(f"attention {shape} {str(dtype)[6:]}: dq / dk / dv "
                  + " / ".join(f"{e:.3g}" for e in errs) + f", bitwise {same}")
            if not ok:
                failed.append(("attention", shape, str(dtype)))
        for *shape, with_state in SSD:
            args = scan(*shape[:6], dtype, gen, with_state)
            got = kssd.launch_bwd(*args, chunk=shape[6])
            again = kssd.launch_bwd(*args, chunk=shape[6])
            want = ref.ssd_chunked_bwd(*args, shape[6])
            errs = [rel(a, w) for a, w in zip(got, want)]
            same = all(torch.equal(a, c) for a, c in zip(got, again))
            tol = 1e-3 if dtype == torch.float32 and shape[6] > 256 else TOL[dtype]
            ok = max(errs) <= tol and same and all(torch.isfinite(t.float()).all() for t in got)
            print(f"ssd {tuple(shape)} state {with_state} {str(dtype)[6:]}: dx / ddt / dA / dB "
                  "/ dC " + " / ".join(f"{e:.3g}" for e in errs) + f", bitwise {same}")
            if not ok:
                failed.append(("ssd", tuple(shape), str(dtype)))

    attn = attention(8, 16, 8, 1024, 1024, 128, True, torch.bfloat16, gen)
    x, dt, A, B, C, dy, _ = scan(8, 1024, 32, 64, 1, 128, torch.bfloat16, gen, False)
    runs = {"flash_attention_bwd": lambda: kfa.launch_bwd(*attn, causal=True),
            "ssd_scan_bwd": lambda: kssd.launch_bwd(x, dt, A, B, C, dy, None, chunk=256)}
    times = {name: ms(fn) for name, fn in runs.items()}
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for fn in runs.values():
            fn()
        torch.cuda.synchronize()
    kernels = {e.key: e.device_time_total for e in prof.key_averages() if e.device_time_total > 0}
    for name, t in times.items():
        print(f"{name}: {t:.4f} ms a call (CUDA events, 20 calls)")
    for name, us in kernels.items():
        print(f"  {us:9.1f} µs  {name[:100]}")
    print(json.dumps({"failed": failed, "ms": times, "kernels_us": kernels}))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
