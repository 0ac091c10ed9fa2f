#!/usr/bin/env python3
"""Time design alternatives of the port's gmm kernel (K4) on one H100.

    PYTHONPATH=src python scripts/gmm_variants.py [--json PATH]

Builds variants of ``src/repro_torch/kernels/csrc/gmm.cu`` with ``nvcc`` (one
process each, started together) by editing copies of its text, loads each
with ``ctypes``, and times them in turns (CUDA events around 20 launches,
the best of two passes) on qwen2-moe-a2.7b's training products at 8 x 1024
tokens (capacity 688, bf16): the forward y = x·w and the backward's two
launches on the transposed views, dx = dy·wᵀ (w read K-major) and dw =
xᵀ·dy (x read MN-major), at the gate/up (E 60, D 2048, F 1408) and down (F
and D swapped) widths, beside ``torch.bmm`` on the same views:

- the kernel as it is;
- the kernel whose epilogue computes its stores but makes none (a condition
  that no launch meets): how long the output's write holds a tile. dw writes
  a (D, F) tile per expert from a contraction of only C = 688 (11 steps of
  64), so there the epilogue weighs most.

Each variant that stores is held against ``torch.bmm`` (fp32 accumulation
either way). Exits non-zero without a CUDA device.
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
from repro_torch.kernels import gmm  # noqa: E402

CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
OUT = ROOT / "build" / "gmm_variants"
SHAPES = {"gate/up": (60, 688, 2048, 1408), "down": (60, 688, 1408, 2048)}
STORE = "        if (r < C && col < F) *reinterpret_cast<uint4*>(yr + col) = out;"
VARIANTS = {"as it is": [],
            "epilogue without stores": [(STORE, STORE.replace("col < F)", "col < F && F < 0)"))]}


def build_variants() -> dict:
    source = (CSRC / "gmm.cu").read_text()
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "hopper.cuh").write_text((CSRC / "hopper.cuh").read_text())
    procs = {}
    for i, (name, edits) in enumerate(VARIANTS.items()):
        text = source
        for old, new in edits:
            if old not in text:
                raise SystemExit(f"variant {name!r}: the source no longer has {old[:60]!r}")
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
        lib.gmm_launch.argtypes = [i32, vp, vp, vp, i32, i32, i32, i32, vp, i32, i32, vp]
        lib.gmm_launch.restype = i32
        libs[name] = lib
    return libs


def launcher(lib, x, w):
    """One launch of ``lib``'s bf16 body on x (E, C, D) and w (E, D, F) as
    they lie (each at the layout ``gmm._layout`` gives it)."""
    e, c, d = x.shape
    f = w.shape[2]
    y = torch.empty((e, c, f), device="cuda", dtype=x.dtype)
    strides = (ctypes.c_longlong * 6)(*x.stride(), *w.stride())
    layouts = (gmm._layout(x), gmm._layout(w))
    if None in layouts:
        raise SystemExit(f"no TMA map describes {x.stride()} or {w.stride()}")

    def run():
        err = lib.gmm_launch(1, x.data_ptr(), w.data_ptr(), y.data_ptr(), e, c, d, f, strides,
                             *layouts, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed: CUDA error {err}")
    return run, y


def event_ms(fn, iters: int = 20) -> float:
    for _ in range(3):
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
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", help="also write the table to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("gmm_variants: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card)
    libs = build_variants()
    gen = torch.Generator(device="cuda").manual_seed(9)
    table = {}
    for label, (e, c, d, f) in SHAPES.items():
        x = torch.randn((e, c, d), generator=gen, device="cuda").bfloat16()
        w = (torch.randn((e, d, f), generator=gen, device="cuda") * d ** -0.5).bfloat16()
        dy = torch.randn((e, c, f), generator=gen, device="cuda").bfloat16()
        products = {"forward x·w": (x, w), "dx = dy·wᵀ": (dy, w.transpose(1, 2)),
                    "dw = xᵀ·dy": (x.transpose(1, 2), dy)}
        rows = {}
        for prod, (a, b) in products.items():
            want = torch.bmm(a, b)
            rows[f"{prod}, torch.bmm"] = {"run": lambda a=a, b=b: torch.bmm(a, b), "ms": [],
                                          "rel_err": None}
            for name, lib in libs.items():
                run, y = launcher(lib, a, b)
                run()
                torch.cuda.synchronize()
                err = None
                if name == "as it is":
                    err = ((y.float() - want.float()).abs().max()
                           / want.float().abs().max()).item()
                rows[f"{prod}, {name}"] = {"run": run, "ms": [], "rel_err": err}
        for _ in range(2):  # in turns: forward, then backward through the list
            for key in list(rows) + list(reversed(list(rows))):
                rows[key]["ms"].append(event_ms(rows[key]["run"]))
        table[label] = {}
        print(f"{label} (E {e}, C {c}, D {d}, F {f}, bf16)  [{card}]")
        for key, r in rows.items():
            ms = min(r["ms"])
            table[label][key] = {"ms": ms, "rel_err": r["rel_err"]}
            err = "" if r["rel_err"] is None else f"  {r['rel_err']:.3g} of max |bmm|"
            print(f"  {ms:.4f} ms  {key}{err}")
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps({"card": card, "table": table}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
