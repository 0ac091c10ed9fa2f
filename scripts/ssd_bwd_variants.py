#!/usr/bin/env python3
"""Time design choices of K3's backward (csrc/ssd_scan_bwd.cu) on one H100.

    PYTHONPATH=src python scripts/ssd_bwd_variants.py [--json PATH]

Builds variants of ``src/repro_torch/kernels/csrc/ssd_scan_bwd.cu`` with
``nvcc`` (one process each, started together) by editing copies of its text,
loads each with ``ctypes`` in place of the module's library, and times one
backward (``ssd_scan.launch_bwd``: three launches, CUDA events around 10
calls, the best of two passes in turns) at mamba2-370m's training shape (B 8,
S 1024, H 32, P 64, G 1, N 128, chunk 256, bf16), with each launch's device
time from torch's profiler:

- the kernel as it is, at 1, 2, 4 and 8 slices of the group's 32 heads
  (``ssd_scan.bwd_plan(..., slices=)``; the plan takes 1: 128 chunk items
  already fill the card, and more slices add dB's and dC's fp32 partials);
- the kernel whose query role takes no products for the tile pairs' scores
  and dS' (it uses whatever its registers hold: timing only, its dC is
  wrong): what computing each pair's C·Bᵀ and dy·xᵀ a second time costs.
  Computing them once would need one CTA to hold, over the heads it sums,
  dC of every query tile of the chunk beside dB of every key tile: 256 KB
  of fp32 sums at chunk 256, N 128, more than a CTA's 227 KB of shared
  memory before any tile (the kernel's header says more).

Each variant that computes the gradient is held against the plain backward
(``ref.ssd_chunked_bwd``, bf16's 2e-2 of max(1, max |plain|)). Exits non-zero
without a CUDA device.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import build as kbuild  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import ssd_scan  # noqa: E402

CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
OUT = ROOT / "build" / "ssd_bwd_variants"
SHAPE = (8, 1024, 32, 64, 1, 128, 256)
SLICES = (1, 2, 4, 8)
SCORES = ("        ss_k<NW>(sc, own_c, at, 0);        // C_t B_j^T\n"
          "        ss_k<PW>(ds, dyt, at + Gm::BT, 0);  // dy_t x_j^T\n")
VARIANTS = {"as it is": [],
            "query role without its scores' products": [(SCORES, "")]}


def build_variants() -> dict:
    source = ssd_scan.BWD_SOURCE.read_text()
    OUT.mkdir(parents=True, exist_ok=True)
    for header in ("hopper.cuh", "warp_tiles.cuh"):
        (OUT / header).write_text((CSRC / header).read_text())
    procs = {}
    for i, (name, edits) in enumerate(VARIANTS.items()):
        text = source
        for old, new in edits:
            if text.count(old) != 1:
                raise SystemExit(f"variant {name!r}: the source no longer has {old[:60]!r} once")
            text = text.replace(old, new)
        src = OUT / f"v{i}.cu"
        src.write_text(text)
        cmd = [kbuild._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-shared", "-Xcompiler", "-fPIC", "-o", str(OUT / f"libv{i}.so"), str(src)]
        procs[name] = (i, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                           text=True))
    libs = {}
    for name, (i, proc) in procs.items():
        _, err = proc.communicate(timeout=kbuild.NVCC_TIMEOUT_S)
        if proc.returncode:
            raise SystemExit(f"nvcc failed on {name!r}:\n{err}")
        lib = ctypes.CDLL(str(OUT / f"libv{i}.so"))
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        lib.ssd_scan_bwd_launch.argtypes = [i32] + [vp] * 13 + [i32] * 8 + [vp, vp]
        lib.ssd_scan_bwd_launch.restype = i32
        lib.ssd_scan_bwd_workspace.argtypes = [i32] * 8
        lib.ssd_scan_bwd_workspace.restype = ctypes.c_longlong
        libs[name] = lib
    return libs


def event_ms(fn, iters: int = 10) -> float:
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def launch_ms(fn, calls: int = 3) -> dict:
    """Device ms a call of each ssd_bwd_* kernel, by symbol."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if "ssd_bwd_" in e.key and e.device_time_total > 0:
            name = "ssd_bwd_" + e.key.split("ssd_bwd_")[1].split("(")[0]
            out[name] = out.get(name, 0.0) + e.device_time_total / calls / 1e3
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", help="also write the table to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ssd_bwd_variants: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card)
    libs = build_variants()
    b, s, h, p, g, n, chunk = SHAPE
    gen = torch.Generator(device="cuda").manual_seed(11)
    x = torch.randn((b, s, h, p), generator=gen, device="cuda").bfloat16()
    dt = torch.nn.functional.softplus(torch.randn((b, s, h), generator=gen, device="cuda") - 2)
    A = -torch.exp(2 * torch.rand((h,), generator=gen, device="cuda"))
    B, C = (torch.randn((b, s, g, n), generator=gen, device="cuda").bfloat16() for _ in "BC")
    dy = torch.randn((b, s, h, p), generator=gen, device="cuda").bfloat16()
    want = ref.ssd_chunked_bwd(x, dt, A, B, C, dy, None, chunk)
    plan = ssd_scan.bwd_plan
    rows = {}
    for name, lib in libs.items():
        for slices in (SLICES if name == "as it is" else (1,)):
            key = f"{name}, {slices} slice{'s' if slices > 1 else ''}"

            def run(lib=lib, slices=slices):
                ssd_scan._bwd_lib = lib
                ssd_scan.bwd_plan = lambda *a, **k: plan(*a, slices=slices)
                try:
                    return ssd_scan.launch_bwd(x, dt, A, B, C, dy, None, chunk=chunk)
                finally:
                    ssd_scan.bwd_plan = plan
            got = run()
            torch.cuda.synchronize()
            err = None
            if name == "as it is":
                err = max(((a.float() - w.float()).abs().max()
                           / w.float().abs().max().clamp_min(1.0)).item()
                          for a, w in zip(got, want))
                if err > 2e-2:
                    raise SystemExit(f"{key}: {err} from the plain backward")
            rows[key] = {"run": run, "ms": [], "rel_err": err, "launch_ms": launch_ms(run),
                         "workspace": plan(b, s, h, p, g, n, chunk, slices=slices).workspace}
    for _ in range(2):  # in turns: down the list, then back up
        for key in list(rows) + list(reversed(list(rows))):
            rows[key]["ms"].append(event_ms(rows[key]["run"]))
    ssd_scan._bwd_lib = None
    print(f"K3 backward at B {b} S {s} H {h} P {p} G {g} N {n} chunk {chunk}, bf16  [{card}]")
    table = {}
    for key, r in rows.items():
        ms = min(r["ms"])
        table[key] = {"ms": ms, "rel_err": r["rel_err"], "launch_ms": r["launch_ms"],
                      "workspace": r["workspace"]}
        err = "" if r["rel_err"] is None else f", {r['rel_err']:.3g} of max(1, max |plain|)"
        print(f"  {ms:.4f} ms  {key} (" + ", ".join(f"{k} {v:.4f}" for k, v in
                                                 r["launch_ms"].items())
              + f"; workspace {r['workspace'] / 1e6:.1f} MB{err})")
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps({"card": card, "table": table}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
