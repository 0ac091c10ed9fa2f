#!/usr/bin/env python3
"""Time design alternatives of the port's ssd_scan kernel (K3) on one H100.

    PYTHONPATH=src python scripts/ssd_scan_variants.py [--json PATH]

Builds variants of ``src/repro_torch/kernels/csrc/ssd_scan.cu`` with ``nvcc``
(one process each, started together) by editing copies of its text, loads
each with ``ctypes``, and times them in turns (CUDA events around 20 launches,
the best of two passes) at mamba2-370m's prefill scan (B 8, S 1024, H 32,
P 64, N 128, chunk 256, bf16), at a long sequence (B 2, S 4096) and at a
long sequence of few heads (B 1, H 8, S 4096):

- the kernel as it is, launched with every cluster size (1, 2, 4, 8 CTAs per
  (batch, head)) and with the B and x tiles streamed through a ring of 2 or
  3 stages instead of held for the whole chunk;
- the kernel with one pass left out (the state contribution, the incoming
  state's product, the intra-chunk products, the exchange through
  distributed shared memory, or all four: the loads, barriers and stores
  alone), which says how long each pass holds the CTA;
- two code alternatives: the masked scores as one bf16 product instead of
  bf16 hi + lo (with its error against the plain version), and the bf16
  k-loops unrolled by 2 instead of fully.

Every variant's y and final state are held against the plain version where
the variant computes the whole scan. Exits non-zero without a CUDA device.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import build as kbuild  # noqa: E402
from repro_torch.kernels import ssd_scan  # noqa: E402
from repro_torch.kernels.ref import ssd_chunked  # noqa: E402

CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
OUT = ROOT / "build" / "ssd_variants"
SHAPES = {"mamba2 prefill": (8, 1024, 32, 64, 1, 128, 256),
          "long sequence": (2, 4096, 32, 64, 1, 128, 256),
          "few heads": (1, 4096, 8, 64, 1, 128, 256)}

# text edits of the source: (what, replacement). A pass left out keeps its
# barriers and loads, so the CTA's protocol is unchanged.
SKIP = {
    "no state pass": [("        state_tile<T, NW>(", "        if (0) state_tile<T, NW>(")],
    "no incoming-state product": [
        ("        inter_rows<T, NW>(ct, sb + lay.state, lr, yacc, lane);",
         "        for (int pb = 0; pb < 8; ++pb) for (int e = 0; e < 4; ++e) yacc[pb][e] = 0.0f;")],
    "no intra-chunk products": [("        if (rows && jt * TJ <= r + 15)", "        if (0)")],
    "no exchange": [("    for (int k = 0; k < upto; ++k) {", "    for (int k = 0; k < 0; ++k) {")],
}
SKIP["loads, barriers and stores alone"] = [e for v in SKIP.values() for e in v]
SCORES_HI = ("#pragma unroll\n      for (int pb = 0; pb < 8; ++pb) mma_bf16(yacc[pb], al, b[pb]);\n"
             "#pragma unroll\n      for (int pb = 0; pb < 8; ++pb) mma_bf16(yacc[pb], ah, b[pb]);\n"
             "    }\n  } else {")
CODE = {
    "scores as one bf16 product": [
        (SCORES_HI, "#pragma unroll\n      for (int pb = 0; pb < 8; ++pb) mma_bf16(yacc[pb], ah, "
                    "b[pb]);\n    }\n  } else {")],
    "bf16 k-loops unrolled by 2": [
        ("#pragma unroll\n    for (int kk = 0; kk < NW / 16; ++kk)",
         "#pragma unroll 2\n    for (int kk = 0; kk < NW / 16; ++kk)")],
}


def build_variants() -> dict:
    source = (CSRC / "ssd_scan.cu").read_text()
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "hopper.cuh").write_text((CSRC / "hopper.cuh").read_text())
    texts = {"as it is": source}
    for name, edits in {**SKIP, **CODE}.items():
        text = source
        for old, new in edits:
            if old not in text:
                raise SystemExit(f"variant {name!r}: the source no longer has {old[:60]!r}")
            text = text.replace(old, new)
        texts[name] = text
    procs = {}
    for i, (name, text) in enumerate(texts.items()):
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
        lib.ssd_scan_launch.argtypes = [i32] + [vp] * 7 + [i32] * 10 + [vp, vp]
        lib.ssd_scan_launch.restype = i32
        libs[name] = lib
    return libs


def inputs(b, s, h, p, g, n, gen):
    """bf16 x, B, C (B and C views into one projection), dt and A in
    mamba2's ranges, as chip_smoke.py's ssd edges draw them."""
    x = torch.randn((b, s, h, p), generator=gen, device="cuda").to(torch.bfloat16)
    lo, hi = math.log(1e-3), math.log(1e-1)
    d0 = torch.exp(torch.empty((h,), device="cuda").uniform_(lo, hi, generator=gen))
    dt = torch.nn.functional.softplus(
        torch.log(torch.expm1(d0)) + 0.5 * torch.randn((b, s, h), generator=gen, device="cuda"))
    A = -torch.empty((h,), device="cuda").uniform_(1.0, 16.0, generator=gen)
    bc = torch.randn((b, s, 2 * g * n), generator=gen, device="cuda").to(torch.bfloat16)
    return x, dt, A, bc[..., :g * n].reshape(b, s, g, n), bc[..., g * n:].reshape(b, s, g, n)


def launcher(lib, args, chunk, cluster, stages, cbufs):
    """One launch of ``lib``'s kernel with the given cluster and buffers."""
    x, dt, A, B, C = args
    b, s, h, p = x.shape
    g, n = B.shape[2:]
    y = torch.empty_like(x)
    st = torch.empty((b, h, p, n), device="cuda")
    strides = (ctypes.c_longlong * 15)(*x.stride()[:3], *y.stride()[:3], *dt.stride(),
                                       *B.stride()[:3], *C.stride()[:3])

    def run():
        err = lib.ssd_scan_launch(1, x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
                                  C.data_ptr(), y.data_ptr(), st.data_ptr(), b, s, h, g, p, n,
                                  chunk, cluster, stages, cbufs, strides,
                                  torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed: CUDA error {err}")
    return run, y, st


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
        print("ssd_scan_variants: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card)
    libs = build_variants()
    sms = kbuild.device_info(0)[1]
    gen = torch.Generator(device="cuda").manual_seed(8)
    table = {}
    for label, (b, s, h, p, g, n, q) in SHAPES.items():
        data = inputs(b, s, h, p, g, n, gen)
        want_y, want_st = ssd_chunked(*data, q)
        pl = ssd_scan.plan(b, s, h, p, n, q, torch.bfloat16, sms)
        tiles = -(-q // ssd_scan.TJ)
        rows = {}
        for name, lib in libs.items():
            settings = [(pl.cluster, pl.stages, pl.cbufs)]
            if name == "as it is":
                settings += [(c, pl.stages, pl.cbufs) for c in (1, 2, 4, 8)
                             if c != pl.cluster and c < 2 * pl.chunks]
                settings += [(pl.cluster, st, 1) for st in (2, 3) if st < tiles]
            for cluster, stages, cbufs in settings:
                run, y, st = launcher(lib, data, q, cluster, stages, cbufs)
                run()
                torch.cuda.synchronize()
                key = f"{name}, cluster {cluster}, " + (
                    "resident" if stages >= tiles else f"{stages} ring stages")
                err = None
                if name in ("as it is", *CODE):
                    err = [((y.float() - want_y.float()).abs().max()
                            / want_y.float().abs().max()).item(),
                           ((st - want_st).abs().max() / want_st.abs().max()).item()]
                rows[key] = {"run": run, "ms": [], "rel_err": err}
        for _ in range(2):  # in turns: forward, then backward through the list
            for key in list(rows) + list(reversed(list(rows))):
                rows[key]["ms"].append(event_ms(rows[key]["run"]))
        table[label] = {}
        print(f"{label} (B {b} S {s} H {h} P {p} N {n} chunk {q}, bf16; the planner takes "
              f"cluster {pl.cluster}, {'resident' if pl.resident else 'streamed'} tiles)  "
              f"[{card}]")
        for key, r in rows.items():
            ms = min(r["ms"])
            table[label][key] = {"ms": ms, "rel_err": r["rel_err"]}
            err = "" if r["rel_err"] is None else (f"  y {r['rel_err'][0]:.3g} of max |y|, "
                                                     f"state {r['rel_err'][1]:.3g}")
            print(f"  {ms:.4f} ms  {key}{err}")
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps({"card": card, "table": table}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
