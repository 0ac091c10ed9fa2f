#!/usr/bin/env python3
"""The backward kernels on the card: K2's and K3's held against their plain
backwards (``ref.flash_attention_bwd``, ``ref.ssd_chunked_bwd``) at a set
of shapes in fp32 and bf16, and K4's (``gmm.Gmm``: dx and dw, two launches
on the transposed views) against autograd of ``ref.gmm_ref``, each twice
bitwise the same; then timed at the training shapes (qwen3-1.7B's
attention, B 8, H 16, KV 8, S 1024, hd 128, causal; mamba2-370m's scan, B
8, S 1024, H 32, P 64, N 128, chunk 256; qwen2-moe-a2.7b's expert products
at 8 x 1024 tokens; bf16) with each launch's device time from torch's
profiler, K4's beside two ``torch.bmm`` calls; K3's launches a call, its
plan's slices and workspace.

    PYTHONPATH=src python scripts/backward_kernels.py

Prints the card's name and power limit, one line per check (each
gradient's max error over max(1, its max |plain value|); K4's over its
plain max), the times, and a last JSON line ``{"failed": [...], "ms":
{...}, "kernels_us": {...}}``; exits 1 when a check fails its limit (fp32
1e-4, bf16 2e-2). K4's checks also fail on an operand copy at a shape
whose views a TMA map describes, and on a missing one where none does.
The fp32 scan at chunk 4096 is held, kernel and plain backward alike,
against the plain backward evaluated in float64 on the same inputs, at
1e-4. Needs a CUDA card; exits 1 without one.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
from repro_torch.kernels import flash_attention as kfa  # noqa: E402
from repro_torch.kernels import gmm as kgmm  # noqa: E402
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
       (1, 130, 32, 64, 1, 128, 256, True), (1, 4096, 2, 64, 1, 128, 4096, False),
       # the backward's own edges: a group's 32 heads over 16 slices, a chunk
       # of 64 (one tile), a chunk of 200 (its last tile 8 positions), S < 64,
       # P 60 (bf16 copies x and dy into padded rows for its TMA maps)
       (1, 512, 32, 64, 1, 128, 256, True), (2, 300, 4, 64, 1, 128, 64, False),
       (2, 700, 4, 64, 1, 128, 200, True), (2, 40, 4, 32, 1, 64, 256, False),
       (1, 300, 4, 60, 1, 128, 128, True)]
# (e, c, d, f, view): K4's backward at the training step's gate/up and down
# products, C ragged (100: dw's K runs past C) and at most 64 (the 64-row
# body), D and F multiples of 8 but not of 64, operands that are
# expert-strided views, and a w whose row stride (F + 4) no TMA map takes
GMM = [(60, 688, 2048, 1408, "contiguous"), (60, 688, 1408, 2048, "contiguous"),
       (4, 100, 256, 384, "contiguous"), (3, 200, 200, 136, "contiguous"),
       (4, 40, 128, 192, "contiguous"), (4, 120, 192, 320, "expert-strided"),
       (3, 96, 128, 200, "unaligned w")]


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


def gmm_backward(e, c, d, f, view, dtype, gen) -> tuple[list, bool, int, int]:
    """dx and dw of ``gmm.gmm`` on the card against autograd of the plain
    version: ([dx, dw errors over each plain max], twice bitwise, launches,
    operand copies)."""
    def draw(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)

    if view == "expert-strided":
        x, w = draw(2 * e, c, d)[::2], draw(2 * e, d, f, scale=d ** -0.5)[1::2]
    elif view == "unaligned w":
        x, w = draw(e, c, d), draw(e, d, f + 4, scale=d ** -0.5)[..., :f]
    else:
        x, w = draw(e, c, d), draw(e, d, f, scale=d ** -0.5)
    x.requires_grad_(True)
    w.requires_grad_(True)
    dy = draw(e, c, f)
    copies = []  # of the backward's operands
    padded = kgmm._padded
    y = kgmm.gmm(x, w)
    before = kgmm.LAUNCHES
    kgmm._padded = lambda *a: copies.append(a) or padded(*a)
    try:
        got = torch.autograd.grad(y, (x, w), dy)
    finally:
        kgmm._padded = padded
    launches = kgmm.LAUNCHES - before
    again = torch.autograd.grad(kgmm.gmm(x, w), (x, w), dy)
    plain = ref.gmm_ref(x, w)
    want = torch.autograd.grad(plain, (x, w), dy)
    errs = [((g.float() - p.float()).abs().max() / p.float().abs().max()).item()
            for g, p in zip(got, want)]
    return errs, all(torch.equal(a, b) for a, b in zip(got, again)), launches, len(copies)


def ssd_float64(shape, with_state, gen) -> dict:
    """The fp32 scan's backward (kernel and plain) against the plain
    backward evaluated in float64 on the same inputs, each gradient's max
    error over max(1, its max |float64 value|)."""
    args = scan(*shape[:6], torch.float32, gen, with_state)
    exact = ref.ssd_chunked_bwd(*(None if a is None else a.double() for a in args), shape[6],
                                acc=torch.float64)
    out = {}
    for name, got in (("kernel", kssd.launch_bwd(*args, chunk=shape[6])),
                      ("plain", ref.ssd_chunked_bwd(*args, shape[6]))):
        out[name] = [rel(g, x) for g, x in zip(got, exact)]
    return out


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
            if dtype == torch.float32 and shape[6] > 256:
                # the plain fp32 backward is itself off here: both against float64
                f64 = ssd_float64(shape, with_state, gen)
                print(f"ssd {tuple(shape)} fp32 against float64: kernel "
                      + " / ".join(f"{e:.3g}" for e in f64["kernel"]) + ", plain "
                      + " / ".join(f"{e:.3g}" for e in f64["plain"]))
                errs = f64["kernel"]
            ok = max(errs) <= TOL[dtype] and same and all(torch.isfinite(t.float()).all()
                                                          for t in got)
            print(f"ssd {tuple(shape)} state {with_state} {str(dtype)[6:]}: dx / ddt / dA / dB "
                  "/ dC " + " / ".join(f"{e:.3g}" for e in errs) + f", bitwise {same}")
            if not ok:
                failed.append(("ssd", tuple(shape), str(dtype)))

        for e, c, d, f, view in GMM:
            errs, same, launches, copies = gmm_backward(e, c, d, f, view, dtype, gen)
            want_copies = 1 if view == "unaligned w" and dtype == torch.bfloat16 else 0
            ok = max(errs) <= TOL[dtype] and same and launches == 2 and copies == want_copies
            print(f"gmm backward {(e, c, d, f)} {view} {str(dtype)[6:]}: dx / dw "
                  + " / ".join(f"{x:.3g}" for x in errs)
                  + f", bitwise {same}, {launches} launches, {copies} operand copies")
            if not ok:
                failed.append(("gmm", (e, c, d, f, view), str(dtype)))

    attn = attention(8, 16, 8, 1024, 1024, 128, True, torch.bfloat16, gen)
    x, dt, A, B, C, dy, _ = scan(8, 1024, 32, 64, 1, 128, torch.bfloat16, gen, False)
    runs = {"flash_attention_bwd": lambda: kfa.launch_bwd(*attn, causal=True),
            "ssd_scan_bwd": lambda: kssd.launch_bwd(x, dt, A, B, C, dy, None, chunk=256)}
    for name, (e, c, d, f) in (("gate/up", (60, 688, 2048, 1408)),
                               ("down", (60, 688, 1408, 2048))):
        gx = torch.randn((e, c, d), generator=gen, device="cuda").bfloat16()
        gw = (torch.randn((e, d, f), generator=gen, device="cuda") * d ** -0.5).bfloat16()
        gdy = torch.randn((e, c, f), generator=gen, device="cuda").bfloat16()
        runs[f"gmm_bwd {name}"] = (lambda gx=gx, gw=gw, gdy=gdy: (
            kgmm.launch(gdy, gw.transpose(1, 2)), kgmm.launch(gx.transpose(1, 2), gdy)))
        runs[f"gmm_bwd {name} dx"] = lambda gw=gw, gdy=gdy: kgmm.launch(gdy, gw.transpose(1, 2))
        runs[f"gmm_bwd {name} dw"] = lambda gx=gx, gdy=gdy: kgmm.launch(gx.transpose(1, 2), gdy)
        runs[f"bmm {name} dx + dw"] = (lambda gx=gx, gw=gw, gdy=gdy: (
            torch.bmm(gdy, gw.transpose(1, 2)), torch.bmm(gx.transpose(1, 2), gdy)))
    attn_sdpa = [t.detach().requires_grad_(True) for t in attn[:3]]
    out_sdpa = torch.nn.functional.scaled_dot_product_attention(
        *attn_sdpa, is_causal=True, enable_gqa=True)
    runs["sdpa backward"] = lambda: torch.autograd.grad(out_sdpa, attn_sdpa, attn[5],
                                                        retain_graph=True)
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
    pl = kssd.bwd_plan(8, 1024, 32, 64, 1, 128, 256)
    k3 = {name.split("ssd_bwd_")[1].split("(")[0]: us for name, us in kernels.items()
          if "ssd_bwd_" in name}
    print(f"ssd_scan_bwd: {kssd.BWD_LAUNCHES} launches a call, {pl.slices} slice(s) of "
          f"{pl.heads} heads, {pl.items} chunk items, workspace {pl.workspace / 1e6:.1f} MB; "
          "device µs over the profiled call: " + ", ".join(f"{k} {v:.1f}" for k, v in k3.items()))
    print(json.dumps({"failed": failed, "ms": times, "kernels_us": kernels}))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
